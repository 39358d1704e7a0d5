"""minicpm-2b [dense]: llama-like arch, trained with the WSD
(warmup-stable-decay) schedule — implemented in the JAX package's train.optimizer.
40L d_model=2304 36H (kv=36 -> MHA, head_dim=64) d_ff=5760 vocab=122753.
[arXiv:2404.06395; hf]

Full attention -> long_500k SKIPPED.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    head_dim=64, d_ff=5760, vocab_size=122753,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="minicpm-2b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
    head_dim=32, d_ff=256, vocab_size=512,
    tie_embeddings=True,
    dtype="float32", remat="none",
)

# training-schedule metadata (the arch's distinguishing training feature)
TRAIN_SCHEDULE = "wsd"
