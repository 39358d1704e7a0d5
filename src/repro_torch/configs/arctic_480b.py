"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP.
35L d_model=7168 56H (kv=8, head_dim=128) d_ff=4864 vocab=32000.
[hf:Snowflake/snowflake-arctic-base; hf]

Dense-MoE hybrid: a small always-on dense MLP runs in parallel ("residual")
with the routed experts. Capacity-bounded top-2 dispatch keeps every shape
static (paper's fixed-dataflow requirement). Full attention ->
long_500k SKIPPED.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, dense_residual_ff=9216,
    moe_dispatch="sorted",
    capacity_factor=1.25,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="arctic-480b-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=128, vocab_size=512,
    num_experts=4, top_k=2, dense_residual_ff=64,
    capacity_factor=1.25,
    dtype="float32", remat="none",
)
