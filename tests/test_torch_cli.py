"""The port's CLI (`python -m bowtie2_tpu_torch.cli`, run with --device cpu)
against the JAX package's CLI: the same index files from `build`, the same
`inspect` output, and SAM files identical apart from the @PG line's CL:
field (the command line), for `align -U` and `align -1/-2` under a sample
of the flag surface: the defaults, --local, --no-unal, --un, -I/-X and the
flag table of tests/test_cli_flags.py. Tolerance: exact (bytes).

Inputs: the shared repcorpus slice of test_torch_corpus.py (reads, and FR
pairs drawn from its genome by numpy). test_torch_cli_lambda.py runs the
same comparison on the lambda phage fixtures.

The port's `align` runs as `python -m bowtie2_tpu_torch.cli`, in processes
of its own started ahead of the tests (PORT_PROCS at a time), while the
JAX package's CLI runs in the test process.
"""

import contextlib
import io
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several test processes at once
torch.set_num_threads(1)
jax = pytest.importorskip("jax")

from bowtie2_tpu.cli.main import main as jmain  # noqa: E402
from bowtie2_tpu_torch.cli.main import main as pmain  # noqa: E402
from test_cli_flags import CASES  # noqa: E402
from test_torch_corpus import corpus  # noqa: E402

ACGTN = np.array(list("ACGTN"))


def _quiet(fn, argv):
    """Run a CLI main in-process with its stderr and stdout captured."""
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn(argv)
    return rc, out.getvalue()


def _fastq(path, recs):
    with open(path, "w") as f:
        for name, seq, qual in recs:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


def _codes(a):
    return "".join(ACGTN[np.asarray(a, np.int64)])


def _qual(q):
    return "".join(chr(int(c) + 33) for c in q)


def _sam(path):
    """SAM lines with the @PG CL: field removed."""
    out = []
    with open(path) as f:
        for line in f:
            if line.startswith("@PG"):
                line = "\t".join(x for x in line.rstrip("\n").split("\t")
                                 if not x.startswith("CL:")) + "\n"
            out.append(line)
    return out


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# port CLI processes at a time, one intra-op thread each
PORT_PROCS = 3


def _port_align(argv):
    """The port's `align` on argv (with --device cpu) in a process of its
    own; returns (exit code, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        x for x in (REPO, os.environ.get("PYTHONPATH")) if x))
    r = subprocess.run([sys.executable, "-m", "bowtie2_tpu_torch.cli",
                        "align"] + argv + ["--device", "cpu"], cwd=REPO,
                       env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True)
    return r.returncode, r.stderr


def _case_dir(d, key):
    out = os.path.join(d, "case_" + "".join(
        c if c.isalnum() else "_" for c in key))
    os.makedirs(out, exist_ok=True)
    return out


def _outputs(d, tag):
    """The SAM file `tag`.sam of case directory d (apart from @PG CL:) and
    the contents of its --un/--al dump files."""
    dumps = sorted(f for f in os.listdir(d) if f.startswith(f"{tag}_un"))
    return (_sam(os.path.join(d, f"{tag}.sam")),
            [open(os.path.join(d, f)).read() for f in dumps])


def start_port_runs(pool, d, pidx, cases):
    """Start the port's align for each (key, inputs, flags) of cases, each
    in its own case directory under d; returns {key: future}."""
    futs = {}
    for key, inputs, flags in cases:
        cd = _case_dir(d, key)
        fl = [x.replace("%DIR%", os.path.join(cd, "p")) for x in flags]
        futs[key] = pool.submit(_port_align, ["-x", pidx, "-S", os.path.join(
            cd, "p.sam")] + inputs + fl)
    return futs


def align_both(d, key, jidx, fut, inputs, flags):
    """The JAX package's CLI on the case's inputs and flags, in this
    process, and the port's run of the same case (fut, from
    start_port_runs); returns both (SAM lines, dump contents)."""
    cd = _case_dir(d, key)
    fl = [x.replace("%DIR%", os.path.join(cd, "j")) for x in flags]
    rc, _ = _quiet(jmain, ["align", "-x", jidx, "-S",
                           os.path.join(cd, "j.sam")] + inputs + fl)
    assert rc == 0
    prc, err = fut.result()
    assert prc == 0, err
    return _outputs(cd, "j"), _outputs(cd, "p")


def _build_both(d, fa):
    for fn, pre in ((jmain, "j"), (pmain, "p")):
        assert _quiet(fn, ["build", fa, os.path.join(d, pre), "-q"])[0] == 0
    return os.path.join(d, "j"), os.path.join(d, "p")


@pytest.fixture(scope="module")
def rep_corpus(tmp_path_factory):
    """A 200-kbp genome, its 100-bp reads of the first 64 (one length
    bucket: each JAX program compiles once per flag set), 48 FR pairs of
    100 bp (inserts 150-550, so some pairs are discordant at -X 500), and
    both indexes."""
    d = str(tmp_path_factory.mktemp("cli_rep"))
    g, reads = corpus(64)
    reads = [r for r in reads if r[1].size == 100]
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        s = _codes(g)
        f.write(">rep chr\n" + "\n".join(s[i:i + 60]
                                         for i in range(0, len(s), 60)) + "\n")
    _fastq(os.path.join(d, "u.fq"),
           [(n, _codes(s), _qual(q)) for n, s, q in reads])
    rng = np.random.default_rng(11)
    m1, m2 = [], []
    for i in range(48):
        p = int(rng.integers(0, g.size - 600))
        ins = int(rng.integers(150, 551))
        a = g[p:p + 100].copy()
        b = (3 - g[p + ins - 100:p + ins])[::-1].copy()
        if i % 6 == 5:                         # mate 2 unalignable
            b = rng.integers(0, 4, 100)
        q = rng.integers(25, 41, 100)
        m1.append((f"p{i}", _codes(a), _qual(q)))
        m2.append((f"p{i}", _codes(b), _qual(q[::-1])))
    _fastq(os.path.join(d, "m1.fq"), m1)
    _fastq(os.path.join(d, "m2.fq"), m2)
    jidx, pidx = _build_both(d, fa)
    return d, fa, jidx, pidx


BASE_FLAGS = [
    ("defaults", []),
    ("local", ["--local"]),
    ("no-unal", ["--no-unal"]),
    ("un", ["--un", "%DIR%_un.fq"]),
    ("I-X", ["-I", "120", "-X", "400"]),
]
FLAG_SETS = BASE_FLAGS + [(name, flags) for name, flags in CASES]
MODES = ["-U", "-1/-2"]


def _inputs(d, mode):
    return (["-U", os.path.join(d, "u.fq")] if mode == "-U" else
            ["-1", os.path.join(d, "m1.fq"), "-2", os.path.join(d, "m2.fq")])


@pytest.fixture(scope="module")
def port_runs(rep_corpus):
    """The port's align of every (flag set, mode) case, started at once."""
    d, _fa, _jidx, pidx = rep_corpus
    with ThreadPoolExecutor(PORT_PROCS) as pool:
        yield start_port_runs(pool, d, pidx, [
            (f"{name} {mode}", _inputs(d, mode), flags)
            for name, flags in FLAG_SETS for mode in MODES])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,flags", FLAG_SETS,
                         ids=[n for n, _ in FLAG_SETS])
def test_cli_align_matches_jax(rep_corpus, port_runs, name, flags, mode):
    d, _fa, jidx, _pidx = rep_corpus
    key = f"{name} {mode}"
    (jsam, jdump), (psam, pdump) = align_both(
        d, key, jidx, port_runs[key], _inputs(d, mode), flags)
    assert len(psam) > 10 or "--qupto" in flags
    assert psam == jsam
    assert pdump == jdump


def test_cli_build_and_inspect_match_jax(rep_corpus):
    d, _fa, jidx, pidx = rep_corpus
    for ext in (".bt2t.json", ".bt2t.npz"):
        with open(jidx + ext, "rb") as f1, open(pidx + ext, "rb") as f2:
            assert f1.read() == f2.read(), ext
    for flags in ([], ["-n"], ["-s"]):
        assert _quiet(jmain, ["inspect", jidx] + flags) == \
            _quiet(pmain, ["inspect", pidx] + flags)
