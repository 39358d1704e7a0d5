"""internlm2-20b [dense]: GQA decoder-only.
48L d_model=6144 48H (kv=8, head_dim=128) d_ff=16384 vocab=92544.
[arXiv:2403.17297; hf]

Full attention -> long_500k SKIPPED.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=16384, vocab_size=92544,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="internlm2-20b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=256, vocab_size=512,
    dtype="float32", remat="none",
)
