"""What the benchmark loads: nothing whose top-level name is jax, jaxlib,
flax or bowtie2_tpu (compared whole: bowtie2_tpu_torch is the port), and
the reference nothing of the port."""

import json
import subprocess
import sys

from portbench.run import FORBIDDEN
from portbench.manifest import ROOT

RUN = r"""
import json, sys, tempfile
from portbench.tests.conftest import tiny_cell
from portbench.run import run_cell, forbidden_modules
d = tempfile.mkdtemp()
run_cell(tiny_cell(d, "se"), 5, 0.1, 1, device="cpu", cache=d)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = r"""
import json, sys
import portbench.reference.check, portbench.reference.control
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_modules(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_modules(RUN)
    assert "bowtie2_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = top_modules(REFERENCE)
    assert not mods & (set(FORBIDDEN) | {"bowtie2_tpu_torch", "torch"})
