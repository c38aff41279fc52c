"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (`build/kernels/<name>.so`, gitignored) at first
use, and loaded with ctypes. Every C entry point launches on the stream it
is given and returns `cudaGetLastError()`; `call` raises when that is not
0. Nothing is built when the package is imported, and a failed build
raises: there is no fallback.

`LAUNCHES` counts kernel launches per kernel name and `PLAIN_CALLS` counts
calls of the plain PyTorch versions (taken only for CPU tensors), so a run
can show which of the two carried it.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import Dict, Iterable

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
SOURCES = ("fm_search", "sa_resolve", "sw_rect", "backtrace")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_CALLS.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale(name: str) -> bool:
    so = os.path.join(OUT, f"{name}.so")
    if not os.path.exists(so):
        return True
    deps = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f == f"{name}.cu" or f.endswith(".cuh")]
    return any(os.path.getmtime(d) > os.path.getmtime(so) for d in deps)


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources, one nvcc process each, all at once.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    names = [n for n in names if _stale(n)]
    if not names:
        return 0.0
    os.makedirs(OUT, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for n in names:
        tmp = os.path.join(OUT, f"{n}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{n}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, os.path.join(OUT, f"{n}.so"))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return time.time() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            _LIBS[name] = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        return _LIBS[name]


def call(name: str, symbol: str, argtypes, *args) -> None:
    """Launch `symbol` of csrc/<name>.cu on the current stream; the stream
    is appended as the last argument. Raises on a non-zero CUDA error."""
    fn = getattr(lib(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [P]
        fn.restype = ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    LAUNCHES[symbol] += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check(t: torch.Tensor, name: str, dtype=torch.int32, shape=None,
          device=None) -> torch.Tensor:
    """Validate a kernel argument: dtype, shape, device and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t


def on_cpu(t: torch.Tensor, plain_name: str) -> bool:
    """Dispatch rule shared by every wrapper: CPU tensors take the plain
    version (counted), CUDA tensors the kernel, anything else raises."""
    if t.device.type == "cpu":
        PLAIN_CALLS[plain_name] += 1
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{plain_name}: no kernel for device {t.device}")
