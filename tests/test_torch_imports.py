"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the CUDA card and raise without one, and its
kernel wrappers refuse devices they have no kernel for."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bowtie2_tpu_torch")


def _port_modules():
    mods = []
    for root, _dirs, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(
                    ".__init__"))
    return mods


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "bowtie2_tpu_torch.pipeline.align" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'bowtie2_tpu.')) or m == 'bowtie2_tpu']\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bowtie2_tpu)(\s|\.|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, fs in os.walk(PKG):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    hits = []
    for f in files:
        with open(f) as fh:
            for m in pat.finditer(fh.read()):
                hits.append((os.path.relpath(f, REPO), m.group(0).strip()))
    assert not hits, hits


def test_package_import_has_no_side_effects():
    code = ("import sys, bowtie2_tpu_torch\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print(bowtie2_tpu_torch.__version__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def _tiny_index():
    from bowtie2_tpu_torch.index.build import build_index_from_refs
    rng = np.random.default_rng(0)
    return build_index_from_refs(
        [("g", rng.integers(0, 4, 3000).astype(np.uint8))], ftab_chars=4)


def test_aligner_defaults_to_the_card():
    from bowtie2_tpu_torch.index.fmindex import FMIndex
    from bowtie2_tpu_torch.pipeline.align import UnpairedAligner
    from bowtie2_tpu_torch.pipeline.policy import make_policy
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    data = _tiny_index()
    with pytest.raises(RuntimeError, match="CUDA"):
        UnpairedAligner(data, make_policy("sensitive"))
    with pytest.raises(RuntimeError, match="CUDA"):
        FMIndex.from_host(data)
    al = UnpairedAligner(data, make_policy("sensitive"), device="cpu")
    assert al.device.type == "cpu"


def test_wrappers_refuse_devices_without_a_kernel():
    from bowtie2_tpu_torch.index.fmindex import FMIndex
    from bowtie2_tpu_torch.ops import _build, fm, sw
    half = FMIndex.from_host(_tiny_index(), device="cpu").fw
    rr = torch.zeros((4, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fm.exact_sweep_rr(half, rr)
    with pytest.raises(ValueError, match="no kernel"):
        sw.sw_banded(rr, rr, torch.zeros(4, dtype=torch.int32,
                                         device="meta"),
                     torch.zeros((4, 20), dtype=torch.int32, device="meta"),
                     sw.SWParams(), 2)
    _build.reset_counts()
    fm.exact_sweep_rr(half, torch.full((4, 8), 5, dtype=torch.int32))
    assert _build.PLAIN_CALLS["fm_sweep"] == 1
    assert not _build.LAUNCHES


def test_kernel_build_needs_nvcc():
    import shutil
    from bowtie2_tpu_torch.ops import _build
    if os.environ.get("NVCC") or shutil.which("nvcc") \
            or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the build is exercised on the card")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
