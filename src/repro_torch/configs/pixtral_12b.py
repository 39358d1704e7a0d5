"""pixtral-12b [vlm]: Pixtral-ViT frontend (STUB) + Mistral-Nemo backbone.
40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336 vocab=131072.
[hf:mistralai/Pixtral-12B-2409; unverified]

Full attention (128k-rope Nemo backbone, no sliding window) ->
long_500k SKIPPED (see DESIGN.md §Arch-applicability).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1e6,
    frontend="vision", frontend_tokens=256,
)

REDUCED = ModelConfig(
    name="pixtral-12b-reduced", family="dense",
    num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
    head_dim=32, d_ff=256, vocab_size=512,
    rope_theta=1e6,
    frontend="vision", frontend_tokens=4,
    dtype="float32", remat="none",
)
