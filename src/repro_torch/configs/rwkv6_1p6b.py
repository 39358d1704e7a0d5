"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent per-channel
decay, matrix-valued WKV state.
24L d_model=2048 (32 heads of 64) d_ff=7168 vocab=65536.
[arXiv:2404.05892; unverified]

Attention-free; decode state O(H*dk*dv) independent of context ->
long_500k RUNS. The paper's attention-sharding aspects are inapplicable
(no attention) — noted in DESIGN.md §Arch-applicability; the static
DMA-schedule/WCET pipeline applies unchanged (WKV update is a subtask).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=7168, vocab_size=65536,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="rwkv6-1.6b-reduced", family="ssm",
    num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    subquadratic=True,
    dtype="float32", remat="none",
)
