"""seamless-m4t-medium [audio]: encoder-decoder, multimodal.
12L (12 enc + 12 dec) d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
[arXiv:2308.11596; hf]

Audio frontend (w2v-BERT conformer stack) is a STUB per the task spec:
input_specs provide precomputed frame embeddings. Full attention enc-dec ->
long_500k SKIPPED. Decode shapes run (decoder is autoregressive).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    num_layers=0, enc_layers=12, dec_layers=12,
    d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab_size=256206,
    qkv_bias=True, norm="layernorm", act="gelu",
    frontend="audio", frontend_tokens=0,
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-reduced", family="encdec",
    num_layers=0, enc_layers=2, dec_layers=2,
    d_model=128, num_heads=4, num_kv_heads=4,
    d_ff=256, vocab_size=512,
    qkv_bias=True, norm="layernorm", act="gelu",
    frontend="audio", frontend_tokens=0,
    dtype="float32", remat="none",
)
