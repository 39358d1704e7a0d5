"""qwen1.5-110b [dense]: QKV bias, GQA.
80L d_model=8192 64H (kv=8, head_dim=128) d_ff=49152 vocab=152064.
[hf:Qwen/Qwen1.5-110B (family ref hf:Qwen/Qwen1.5-0.5B); hf]

Full attention -> long_500k SKIPPED. Largest dense arch in the pool
(~110B params) — ZeRO-1 optimizer sharding required to fit train state.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=49152, vocab_size=152064,
    qkv_bias=True,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-110b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
    head_dim=32, d_ff=384, vocab_size=512,
    qkv_bias=True,
    dtype="float32", remat="none",
)
