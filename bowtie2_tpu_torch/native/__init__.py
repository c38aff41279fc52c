"""Native (C) host components, built lazily with the system compiler.

  * sais    — linear-time SA-IS suffix sorting for index construction
  * samemit — batched CIGAR/MD decode, SAM line tails and read padding

The shared libraries are built on first import into `build/native/` beside
the package (gitignored), not into a per-user cache: the JAX package builds
same-named libraries from its own sources, and two trees sharing one cache
directory would load each other's builds. Failures fall back to the
pure-NumPy implementations (callers catch ImportError).
"""

import os
import subprocess

_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "native")


def _build(name: str, src: str) -> str:
    os.makedirs(_CACHE, exist_ok=True)
    so = os.path.join(_CACHE, f"{name}.so")
    csrc = os.path.join(os.path.dirname(__file__), src)
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(csrc)):
        cc = os.environ.get("CC", "cc")
        # per-process temp name: concurrent test workers may build at once
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [cc, "-O3", "-fPIC", "-shared", "-o", tmp, csrc]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so
