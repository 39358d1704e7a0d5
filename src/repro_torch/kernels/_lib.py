"""Build, load and count the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc` process
(all started together) into `build/repro_torch_kernels/<hash>/lib<name>.so`
under the checkout, where `<hash>` covers every file in `csrc/`: an edited
source builds anew, an unchanged one loads the cached library. The
libraries export plain C entry points, bound here with ctypes; each returns
the CUDA error code of its launch, and `check` raises on anything but 0.

Nothing is built or loaded at import time. A missing `nvcc`, a failed build
or a failed load raises.

Launch counters: every kernel wrapper adds one to its counter per call, on
the path it takes (the kernel on a CUDA tensor, the plain version on a CPU
tensor). `reset_launch_counts` / `launch_counts` read them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("gemm_int8", "conv2d_im2col", "megakernel")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

KERNELS = ("gemm_int8", "conv2d_int8", "megakernel")
_COUNTS = {k: 0 for k in KERNELS}


def count_launch(kernel: str) -> None:
    _COUNTS[kernel] += 1


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(_COUNTS)


def sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def build_all(verbose: bool = False) -> Path:
    """Compile every source that has no library for the current hash, one
    nvcc per source, all in parallel. Returns the build directory."""
    out_dir = BUILD_ROOT / sources_hash()
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = out_dir / f"lib{s}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{s}.cu")]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        if verbose and log:
            print(f"[nvcc {s}]\n{log}", flush=True)
        if p.returncode != 0:
            errors.append(f"nvcc {s}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{s}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return out_dir


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes/restype of every exported entry point."""
    P, I = ctypes.c_void_p, ctypes.c_int
    table = {
        "gemm_int8_launch": [P, P, P, I, P, I, I, I, P],
        "conv2d_int8_launch": [P, P, P, I, P, I, I, I, I, I, I, I, I, I, P],
        "megakernel_launch": [P, I, P, I, P, I, P, I, P],
        "megakernel_max_grid": [ctypes.POINTER(ctypes.c_int)],
    }
    for name, args in table.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = ctypes.c_int
    lib.error_string.argtypes = [I]
    lib.error_string.restype = ctypes.c_char_p


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>.cu`, building it if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            path = build_all() / f"lib{source}.so"
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _LIBS[source] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
