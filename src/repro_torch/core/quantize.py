"""int8 post-training quantization (paper §IV.A: Zve32x -> int8 nets).

Symmetric quantization: per-output-channel scales for weights, per-tensor
scales for activations (calibrated from sample activations). GEMMs accumulate
in int32 and are folded back to int8 through a fixed-point requantization
multiplier — the same math the executor's subtasks and the CUDA int8 GEMM
kernel's epilogue use, so tiled and whole-layer paths agree bit-exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QuantParams:
    """Fixed-point requant: y_int8 = clip(round_half_up(acc * m / 2^s))."""
    multiplier: int
    shift: int

    @staticmethod
    def from_scale(scale: float, bits: int = 31) -> "QuantParams":
        """Represent `scale` as m / 2^s with m in [2^(bits-1), 2^bits)."""
        if scale <= 0:
            return QuantParams(0, 0)
        s = 0
        while scale < 2 ** (bits - 1) / 2 ** 31 or scale * 2 ** s < 2 ** (bits - 1):
            s += 1
            if s > 62:
                break
        m = int(round(scale * 2 ** s))
        while m >= 2 ** bits:
            m //= 2
            s -= 1
        return QuantParams(m, s)

    def scale(self) -> float:
        return self.multiplier / 2 ** self.shift


def quantize_weight(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """f32 (K, N) -> (int8 (K, N), per-channel scale (N,))."""
    amax = np.maximum(np.abs(w).max(axis=0), 1e-8)
    scale = amax / 127.0
    q = np.clip(np.round(w / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_activation_scale(calib: np.ndarray) -> float:
    """Per-tensor activation scale from calibration data (abs-max)."""
    return float(max(np.abs(calib).max(), 1e-8) / 127.0)


def quantize_tensor(x: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(x / scale), -128, 127).astype(np.int8)


def dequantize(q: np.ndarray, scale) -> np.ndarray:
    return q.astype(np.float32) * scale


def requant_multiplier(in_scale: float, w_scale: np.ndarray,
                       out_scale: float) -> np.ndarray:
    """Per-channel effective requant scale: acc*in*w/out."""
    return (in_scale * w_scale / out_scale).astype(np.float32)


def requantize(acc_i32: torch.Tensor, mult) -> torch.Tensor:
    """int32 accumulator -> int8 with float multiplier (round-half-even,
    matching torch.round; identical math used by kernel epilogue and ref)."""
    mult = torch.as_tensor(mult, dtype=torch.float32, device=acc_i32.device)
    y = torch.round(acc_i32.to(torch.float32) * mult)
    return torch.clamp(y, -128, 127).to(torch.int8)


def sqnr_db(ref: np.ndarray, test: np.ndarray) -> float:
    err = ref.astype(np.float64) - test.astype(np.float64)
    p_sig = np.mean(ref.astype(np.float64) ** 2) + 1e-30
    p_err = np.mean(err ** 2) + 1e-30
    return float(10.0 * np.log10(p_sig / p_err))
