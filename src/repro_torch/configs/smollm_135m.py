"""smollm-135m [dense]: llama-arch small, tied embeddings.
30L d_model=576 9H (GQA kv=3, head_dim=64) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M; hf]

Full attention -> long_500k SKIPPED. Also the end-to-end training example
target (~135M params trains on CPU at reduced depth).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
    head_dim=64, d_ff=1536, vocab_size=49152,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="smollm-135m-reduced", family="dense",
    num_layers=3, d_model=192, num_heads=3, num_kv_heads=1,
    head_dim=64, d_ff=512, vocab_size=512,
    tie_embeddings=True,
    dtype="float32", remat="none",
)
