"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block.
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]

The single shared attention(+MLP) block is applied every `attn_every`
Mamba2 blocks with tied weights (the Zamba2 design). SSM state is O(1) in
sequence length -> long_500k RUNS (shared-attn KV cache kept for the few
application points only).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    head_dim=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, attn_every=6,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="hybrid",
    num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512,
    ssm_state=16, attn_every=2,
    subquadratic=True,
    dtype="float32", remat="none",
)
