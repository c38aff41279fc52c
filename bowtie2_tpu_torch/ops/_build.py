"""Build, load and count the hand-written CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface (`build/kernels/<name>.so`, gitignored) at first
use, and loaded with ctypes. Every C entry point launches on the stream it
is given and returns `cudaGetLastError()`; `call` raises when that is not
0. Nothing is built when the package is imported, and a failed build
raises: there is no fallback.

`LAUNCHES` counts kernel launches per kernel name and `PLAIN_CALLS` counts
calls of the plain PyTorch versions (taken only for CPU tensors), so a run
can show which of the two carried it. `PTXAS` keeps, per source built in
this process, each kernel's registers, spills and shared memory as
`ptxas -v` reported them.
"""

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import Dict, Iterable, Optional, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "kernels")
SOURCES = ("fm_search", "sa_resolve", "sw_rect", "backtrace", "sw_diag",
           "take_sharded", "ref_gather", "pe_pairing", "diag_readout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

LAUNCHES: Counter = Counter()
PLAIN_CALLS: Counter = Counter()
PTXAS: Dict[str, Dict[str, dict]] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint


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


# the template arguments of this repo's kernels that are types: the FM
# kernels' row type (int, or uint32_t in the large mode), K12's index type
# and K7's and K10 PE's position type (int, or long long); and their row
# sources (csrc/fm_common.cuh), of
# which the flat table is not shown
_TYPE_ARGS = {"i": "int", "j": "uint32", "x": "int64"}
_SOURCE_ARGS = {"FlatRows": None, "ShardRows": "sh"}


def _template_args(s: str) -> Optional[list]:
    """The shown template arguments at the start of a mangled name's rest
    (`I...E`): integer and bool literals, the types of _TYPE_ARGS and the
    row sources of _SOURCE_ARGS; [] without arguments, None for any other
    argument."""
    if not s.startswith("I"):
        return []
    i, out = 1, []
    while i < len(s) and s[i] != "E":
        lit = re.match(r"L[a-z](n?\d+)E", s[i:])
        num = re.match(r"\d+", s[i:])
        if s[i] in _TYPE_ARGS:
            out.append(_TYPE_ARGS[s[i]])
            i += 1
        elif lit:
            out.append(lit.group(1))
            i += lit.end()
        elif num:
            k = num.end()
            name = s[i + k:i + k + int(num.group())]
            if name not in _SOURCE_ARGS:
                return None
            if _SOURCE_ARGS[name]:
                out.append(_SOURCE_ARGS[name])
            i += k + len(name)
        else:
            return None
    return out if i < len(s) else None


def kernel_name(mangled: str) -> str:
    """`_ZN12_GLOBAL__N_114sw_warp_kernelILi1ELb0EEEvNS_4ArgsENS_8SwParamsE`
    -> `sw_warp_kernel<1,0>`: the innermost name of a (nested) Itanium
    name and its integer or bool template arguments, its int, unsigned or
    int64 type arguments (`sweep_kernel<uint32>`) and its row source
    (`sweep_kernel<int,sh>`), enough to tell this repo's kernels apart;
    anything else is returned as it is."""
    if not mangled.startswith("_Z"):
        return mangled
    i = 2
    nested = mangled.startswith("N", i)
    i += nested
    names = []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        k = int(mangled[i:j])
        names.append(mangled[j:j + k])
        i = j + k
        if not nested:
            break
    names = [n for n in names if not n.startswith("_GLOBAL__N")]
    if not names:
        return mangled
    args = _template_args(mangled[i:]) or []
    return names[-1] + (f"<{','.join(args)}>" if args else "")


def ptxas_usage(text: str) -> Dict[str, dict]:
    """Per kernel: registers, spill stores/loads and stack bytes, and
    static shared memory, from `nvcc -Xptxas=-v` output."""
    out: Dict[str, dict] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            cur = out.setdefault(kernel_name(m.group(1)), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


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
        text = out.decode(errors="replace")
        if p.returncode != 0:
            errors.append(f"{n}.cu:\n{text}")
        else:
            PTXAS[n] = ptxas_usage(text)
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


def call(name: str, symbol: str, argtypes, *args,
         kinds: Optional[Sequence[str]] = None) -> Optional[str]:
    """Launch `symbol` of csrc/<name>.cu on the current stream; the stream
    is appended as the last argument. Raises on a non-zero CUDA error.
    Counts the launch under `symbol` and returns that name. An entry that
    picks one of several kernels names them in `kinds`: it then takes a
    host int before the stream, where it writes the index of the kernel it
    launched (-1: none), and the launch is counted under that kind."""
    fn = getattr(lib(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [P] * (kinds is not None) + [P]
        fn.restype = ctypes.c_int
    kind = ctypes.c_int(0)
    extra = [ctypes.addressof(kind)] if kinds is not None else []
    err = fn(*args, *extra, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    counted = symbol if kinds is None else \
        (kinds[kind.value] if kind.value >= 0 else None)
    if counted is not None:
        LAUNCHES[counted] += 1
    return counted


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
