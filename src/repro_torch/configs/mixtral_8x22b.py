"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
56L d_model=6144 48H (kv=8, head_dim=128) d_ff=16384 vocab=32768.
[arXiv:2401.04088; hf]

SWA (4096) bounds the decode KV working set -> sub-quadratic ->
long_500k RUNS (rolling-window cache; here the static cache keeps max_len
but attention only reads the window — the roofline counts window reads).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=32768,
    num_experts=8, top_k=2, moe_dispatch="sorted",
    sliding_window=4096,
    subquadratic=True,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced", family="moe",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=128, vocab_size=512,
    num_experts=4, top_k=2,
    sliding_window=8,
    subquadratic=True,
    dtype="float32", remat="none",
)
