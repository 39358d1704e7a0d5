"""Build, load and count the package's CUDA kernels.

Each `csrc/<name>.cu` is compiled on first use by its own `nvcc` process
(all started together) into `build/repro_torch_kernels/<hash>/lib<name>.so`
under the checkout, where `<hash>` covers every file in `csrc/`: an edited
source builds anew, an unchanged one loads the cached library. The
libraries export plain C entry points, bound here with ctypes; each returns
the CUDA error code of its launch, and `check` raises on anything but 0.

Nothing is built or loaded at import time. A missing `nvcc`, a failed build
or a failed load raises.

Launch counters: a kernel wrapper adds one to its counter after its kernel
launched without error, and nowhere else; a call that takes the plain
version (a CPU tensor) counts nothing. A CUDA graph's capture takes the
launches it counted off again, and each replay adds them back
(`add_launches`), so the counters say what the card ran.
`reset_launch_counts` / `launch_counts` read them. The kernels of
`BYTE_KERNELS` also count the bytes each launch moves at least
(`byte_counts`, taken off and added back as launches are). Beside them,
`graph_counts` counts the `cuda` backend's program calls by how they ran
(`compiler/backends.py::GraphedRunner`): "eager", "captures", "replays"
and "capture_failures"; `reset_launch_counts` zeroes both.

The libraries launch on the current device: a wrapper makes its tensors'
card current around the call (`with torch.cuda.device(...)`). No wrapper
returns a result cut off from autograd: K4 and K5 go through an autograd
Function under grad (kernel forward, the plain version's gradient); K1, K2
and K3, which take float multipliers beside int8 data, call `refuse_grad`
first, on every device (K6 takes int8 tensors only, which cannot require
grad).
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
SOURCES = ("gemm_int8", "conv2d_im2col", "megakernel", "flash_attention",
           "ssm_scan", "tiled_int8", "lut_int8")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

KERNELS = ("gemm_int8", "conv2d_int8", "megakernel", "flash_attention",
           "ssm_scan", "tiled_int8", "lut_int8")
_COUNTS = {k: 0 for k in KERNELS}
BYTE_KERNELS = ("lut_int8",)
_BYTES = {k: 0 for k in BYTE_KERNELS}


GRAPH_EVENTS = ("captures", "replays", "eager", "capture_failures")
_GRAPHS = {k: 0 for k in GRAPH_EVENTS}


def count_launch(kernel: str) -> None:
    _COUNTS[kernel] += 1


def add_launches(counts: dict[str, int]) -> None:
    """Add `counts` (kernel -> launches; negative takes launches off) to
    the launch counters."""
    for k, n in counts.items():
        _COUNTS[k] += n


def count_bytes(kernel: str, n: int) -> None:
    _BYTES[kernel] += n


def add_bytes(counts: dict[str, int]) -> None:
    """Add `counts` (kernel -> bytes; negative takes bytes off) to the byte
    counters."""
    for k, n in counts.items():
        _BYTES[k] += n


def count_graph(event: str) -> None:
    _GRAPHS[event] += 1


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise `RuntimeError` if grad mode is on and an input of `kernel`
    (which has no backward) requires grad: its output would be cut off
    from the graph, and the gradients would be lost without an error."""
    import torch
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward, and an input requires "
            "grad; call it under torch.no_grad() or on detached inputs")


def reset_launch_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0
    for k in _BYTES:
        _BYTES[k] = 0
    for k in _GRAPHS:
        _GRAPHS[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(_COUNTS)


def byte_counts() -> dict[str, int]:
    return dict(_BYTES)


def graph_counts() -> dict[str, int]:
    return dict(_GRAPHS)


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
    nvcc per source, all in parallel. Returns the build directory.
    `verbose`: ptxas reports every kernel's registers and spills, printed
    and kept beside each library as `lib<name>.ptxas.txt`."""
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
            (out_dir / f"lib{s}.ptxas.txt").write_text(log)
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
    L, F = ctypes.c_longlong, ctypes.c_float
    table = {
        "gemm_int8_launch": [P, P, P, I, P, I, I, I, I, P, P, P],
        "conv2d_int8_launch": [P, P, P, I, P, I, I, I, I, I, I, I, I, I,
                               I, P, P, P],
        "megakernel_launch": [P, I, P, I, P, I, P, I, I, P, L, P, I, P],
        "megakernel_max_grid": [ctypes.POINTER(ctypes.c_int)],
        "flash_attention_launch": [P, P, P, P, I, I, I, I, I, I, I, I, F, I,
                                   P],
        "ssm_scan_launch": [P, P, P, P, I, I, L, P],
        "tiled_int8_launch": [P, P, I, P, I, I, I, I, P, I, I, I, I, I, I,
                              I, I, I, P, P, I, P],
        "lut_int8_launch": [P, P, P, L, P],
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


# -- the route a tensor takes -------------------------------------------------

_ROUTE = threading.local()


class cost_route:
    """`with cost_route("cuda"):` sends fake tensors (`FakeTensorMode`,
    which allocates nothing) of any device down the route named: "cuda",
    the kernels' custom ops, whose fake implementations give the result's
    shape without a launch; or "ref", the plain versions. The dry run
    costs the card's path this way on a host without one: autograd cannot
    record fake CUDA tensors where torch has no CUDA. Real tensors are
    routed by their device whatever the context says."""

    def __init__(self, route: str):
        if route not in ("cuda", "ref"):
            raise ValueError(f"cost route {route!r}: 'cuda' or 'ref'")
        self.route = route

    def __enter__(self):
        self.prev = getattr(_ROUTE, "route", None)
        _ROUTE.route = self.route
        return self

    def __exit__(self, *exc):
        _ROUTE.route = self.prev


def route_of(t) -> str:
    """"cuda" (the kernel) or "ref" (the plain version) for tensor `t`:
    its device's route, or the `cost_route` for a fake tensor."""
    forced = getattr(_ROUTE, "route", None)
    if forced is not None:
        from torch._subclasses.fake_tensor import is_fake
        if is_fake(t):
            return forced
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "ref"
    raise ValueError(f"no kernel route for device {t.device}")


def seen(t) -> bool:
    """True when a launch on `t` must go through its kernel's custom op:
    `t` is fake, or a dispatch mode (the op counter, a FLOP counter) is
    active and has to see the op. Otherwise the wrapper calls the launch
    directly and spares the decode loops the custom op's host dispatch."""
    import torch
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t) or torch._C._len_torch_dispatch_stack() > 0
