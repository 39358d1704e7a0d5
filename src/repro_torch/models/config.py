"""Model configuration shared by every architecture family.

One `ModelConfig` describes any of the assigned archs; the family field
selects the block stack (dense / moe / hybrid / ssm / encdec). Exact sizes
for the 10 assigned architectures live in `repro_torch.configs.<id>`.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    # attention options
    qkv_bias: bool = False
    sliding_window: int | None = None
    rope_theta: float = 1e4
    # MoE
    num_experts: int = 0
    top_k: int = 2
    dense_residual_ff: int = 0        # arctic: parallel always-on dense MLP
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    moe_dispatch: str = "onehot"      # "onehot" | "sorted" (perf variant)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_conv: int = 4
    attn_every: int = 0               # hybrid: shared attn block period
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # frontends ([vlm]/[audio] are STUBS: precomputed embeddings)
    frontend: str | None = None       # None | "vision" | "audio"
    frontend_tokens: int = 0
    # misc
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # long-context capability (decode state is O(1) or windowed)
    subquadratic: bool = False
    # remat policy for the layer scan:
    # "none" | "full" | "dots" | "save_residuals"
    remat: str = "full"
    # FSDP/ZeRO-3: additionally shard params over the data axis; XLA
    # all-gathers each layer's weights inside the scan (per use)
    fsdp: bool = False
    # KV-cache storage: "model" (= activation dtype) | "int8" (per-position
    # per-head scales; halves decode cache traffic — §Perf)
    kv_cache_dtype: str = "model"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def layers(self) -> int:
        return self.num_layers if self.family != "encdec" \
            else self.enc_layers + self.dec_layers

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND MODEL_FLOPS)."""
        D, F, V, Hd = self.d_model, self.d_ff, self.vocab_size, self.hd
        embed = V * D * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":            # rwkv6-style
            att = 5 * D * D + 2 * D         # r,k,v,g,o + w lora-ish
            ffn = 2 * D * F                 # rwkv channel-mix (no gate)
            return embed + self.num_layers * (att + ffn)
        attn = D * (self.num_heads * Hd) * 2 \
            + D * (self.num_kv_heads * Hd) * 2
        glu = 3 if self.act == "swiglu" else 2
        if self.family == "moe":
            ffn = self.num_experts * glu * D * F \
                + D * self.num_experts \
                + (3 * D * self.dense_residual_ff
                   if self.dense_residual_ff else 0)
        else:
            ffn = glu * D * F
        if self.family == "hybrid":
            # mamba2 blocks + one shared attention/mlp block
            din = 2 * D
            ssm = D * (2 * din + 2 * self.ssm_state + din // 64) \
                + din * D + self.ssm_conv * din
            shared = attn + glu * D * F
            return embed + self.num_layers * ssm + shared
        per_layer = attn + ffn
        n_layers = self.layers
        return embed + n_layers * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D, F = self.d_model, self.d_ff
        glu = 3 if self.act == "swiglu" else 2
        total = self.param_count()
        all_experts = self.num_layers * self.num_experts * glu * D * F
        active = self.num_layers * self.top_k * glu * D * F
        return total - all_experts + active
