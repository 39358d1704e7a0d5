"""K4: blockwise GQA attention with an online softmax (flash attention).

The CUDA kernel is `csrc/flash_attention.cu` (it replaces the JAX
package's `kernels/flash_attention.py::flash_attention_pallas`): f16 and
bf16 inputs run on the tensor cores (16-bit products, f32 softmax state,
P rounded to the input's type before P V), f32 inputs on the CUDA cores in
f32 throughout. `flash_attention_plain` is its plain torch version, which
the wrapper takes for CPU tensors only. Both keep the Pallas kernel's
semantics: the causal mask with the decode offset Skv - Sq, the optional
sliding window, the `scale` override, the -1e30 sentinel and
`acc / max(l, 1e-30)`.

K4 has no backward kernel. Under autograd `FlashAttentionFn` runs K4
forward and differentiates the plain attention in its backward.

Where a dispatch mode watches (`FakeTensorMode` in the dry run, the op
counter, `torch.utils.flop_counter`) the launch is the custom op
`torch.ops.repro_torch.flash_attention` (CUDA only), with a fake
implementation, which gives the result's shape and launches nothing,
and a FLOP formula: 4 x B x Hq x D per (q, k) pair that the masks leave
visible (Q K^T and P V; the kernel skips the kv tiles no row of a q tile
can see). Otherwise the wrapper calls the launch directly, without the
custom op's dispatch on the host (`_lib.seen`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from . import _lib, ref
from .ref import NEG

# the kernel's kv tile; the plain version walks the kv axis in the same
# 64-row tiles
BK = 64
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: expected "
                         "(B, Hq, Sq, D) and two (B, Hkv, Skv, D)")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[1] != 0:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and kv "
                         f"{tuple(k.shape)} do not match (Hq % Hkv == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes one float dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")


def attention_blockwise(q, k, v, *, causal=True, window=None,
                        scale: float | None = None, q_chunk=1024,
                        kv_chunk=1024):
    """Flash-style attention in plain torch: the online softmax with f32
    (m, l, acc) state over kv chunks, per q chunk (the JAX package's
    `models/attention.py::attention_blockwise`, whose `lax.scan`s become
    loops). Never materializes more than (q_chunk x kv_chunk) logits per
    (b, kv-head, group)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    offs = Skv - Sq
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Skv)
    qg = (q.float() * scale).reshape(B, Hkv, g, Sq, D)
    kf, vf = k.float(), v.float()
    dev = q.device
    outs = []
    for q0 in range(0, Sq, qc):
        q1 = min(Sq, q0 + qc)
        n = q1 - q0
        m = torch.full((B, Hkv, g, n, 1), NEG, device=dev)
        l = torch.zeros((B, Hkv, g, n, 1), device=dev)
        acc = torch.zeros((B, Hkv, g, n, D), device=dev)
        qpos = torch.arange(q0, q1, device=dev)[:, None] + offs
        for k0 in range(0, Skv, kc):
            k1 = min(Skv, k0 + kc)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qg[:, :, :, q0:q1],
                             kf[:, :, k0:k1])
            kpos = torch.arange(k0, k1, device=dev)[None, :]
            mask = torch.ones((n, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos <= qpos
            if window is not None:
                mask &= kpos > qpos - window
            s = torch.where(mask, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), torch.zeros_like(s))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                            vf[:, :, k0:k1])
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    out = torch.cat(outs, dim=3)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The kernel's function in plain torch: the online softmax over kv
    tiles of 64 rows, every q row at once. (The kernel also skips tiles no
    row of its q tile can see; a fully masked tile leaves (m, l, acc) as
    they are, so skipping changes no value.)"""
    return attention_blockwise(q, k, v, causal=causal, window=window,
                               scale=scale, q_chunk=q.shape[2], kv_chunk=BK)


# Up to this many positions the plain attention is the direct oracle;
# beyond, the blockwise online softmax (`attention_reference`).
BLOCKWISE_THRESHOLD = 4096


def attention_reference(q, k, v, *, causal=True, window=None,
                        scale: float | None = None,
                        blockwise_threshold: int | None = None):
    """The plain attention that `models.attention.attend` runs on CPU
    tensors, and that K4's backward differentiates: the direct oracle
    (`ref.flash_attention`) up to `blockwise_threshold` positions
    (`BLOCKWISE_THRESHOLD` when None), the blockwise online softmax
    beyond."""
    if blockwise_threshold is None:
        blockwise_threshold = BLOCKWISE_THRESHOLD
    if max(q.shape[2], k.shape[2]) <= blockwise_threshold:
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale)
    return attention_blockwise(q, k, v, causal=causal, window=window,
                               scale=scale)


def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """(q, k) pairs that the causal mask (with the decode offset Skv - Sq)
    and the window leave visible, over one (batch row, head)."""
    qpos = np.arange(Sq, dtype=np.int64) + (Skv - Sq)
    hi = np.minimum(Skv - 1, qpos) if causal else np.full(Sq, Skv - 1)
    lo = (np.maximum(0, qpos - window + 1)
          if window is not None and window >= 0 else 0)
    return int(np.maximum(0, hi - lo + 1).sum())


def _k4_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, window: int, scale: float) -> torch.Tensor:
    """One K4 launch (counted) on contiguous CUDA tensors; window -1 is
    none."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    out = torch.empty_like(q)
    lib = _lib.load("flash_attention")
    # the library launches on the current device: make it q's
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Skv, D, int(causal), window, scale,
            _DTYPES[q.dtype], _lib.stream_ptr(q))
    _lib.check(lib, err, "flash_attention")
    _lib.count_launch("flash_attention")
    return out


_k4 = torch.library.custom_op("repro_torch::flash_attention", _k4_launch,
                              mutates_args=(), device_types="cuda")


@_k4.register_fake
def _(q, k, v, causal, window, scale):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _k4_flops(q_shape, k_shape, v_shape, causal, window, scale, *args,
              out_shape=None, **kwargs) -> int:
    B, Hq, Sq, D = q_shape
    return 4 * B * Hq * D * visible_pairs(Sq, k_shape[2], causal,
                                          None if window < 0 else window)


def _kernel_forward(q, k, v, causal, window, scale):
    """K4 on CUDA tensors (one launch, counted), `flash_attention_plain`
    on CPU tensors (the route of `_lib.route_of`)."""
    if _lib.route_of(q) == "ref":
        return flash_attention_plain(q, k, v, causal, window, scale)
    B, Hq, Sq, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if B * Hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {B * Hq} > 65535")
    launch = _k4 if _lib.seen(q) else _k4_launch
    return launch(
        q.contiguous(), k.contiguous(), v.contiguous(), bool(causal),
        -1 if window is None else int(window),
        float(1.0 / (D ** 0.5) if scale is None else scale))


class FlashAttentionFn(torch.autograd.Function):
    """K4 under autograd. The forward is K4 (its plain version on CPU
    tensors) and saves q, k and v; the backward recomputes
    `attention_reference` on the same inputs and differentiates it with
    `torch.autograd.grad`. This is the JAX package's training semantics:
    its Pallas call has no rule for differentiation, so it trains through
    the jnp oracle's autodiff. A backward kernel would be speed work."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return _kernel_forward(q, k, v, causal, window, scale)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            out = attention_reference(*ins, **ctx.opts)
            wrt = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(out, wrt, dout))
        grads = [next(got) if n else None for n in need]
        return (*grads, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype (f32, f16 or bf16; softmax in f32, products in f32 for f32
    inputs and in the input's type otherwise). `scale` overrides
    1/sqrt(D).

    On a CUDA tensor this launches K4; on a CPU tensor it runs
    `flash_attention_plain`. A kernel launch counts one; the plain version
    counts none. With grad mode on and an input that requires grad, the
    call goes through `FlashAttentionFn`, whose backward differentiates
    `attention_reference`.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    return _kernel_forward(q, k, v, causal, window, scale)
