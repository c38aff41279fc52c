"""Shared constants: alphabet encoding and index geometry defaults.

Encoding: A=0, C=1, G=2, T=4's complement… no — A=0, C=1, G=2, T=3, N=4.
Complement(c) = 3 - c for c in 0..3; N stays N.

Index geometry mirrors the knobs of the reference (bt2_idx.h:112-278
EbwtParams: offRate=5, ftabChars=10) but the on-device layout is our own:
SoA int32 arrays with occ checkpoints per 128-base block, and the SA sample
marked by *text position* (every position ≡ 0 mod 2^OFF_RATE) so that the
LF-walk to resolve an offset is bounded by 2^OFF_RATE steps — a fixed trip
count, which is what a TPU scan wants. (The reference marks by BWT row
index, giving unbounded worst-case walks; bt2_idx.h:1607 walkLeft.)
"""

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4

# char -> code (uppercase and lowercase; everything else = N)
_CHAR_TO_CODE = np.full(256, N, dtype=np.uint8)
for i, ch in enumerate("ACGT"):
    _CHAR_TO_CODE[ord(ch)] = i
    _CHAR_TO_CODE[ord(ch.lower())] = i
CODE_TO_CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

def encode_seq(s: bytes) -> np.ndarray:
    """ASCII bytes -> uint8 codes (N for ambiguous)."""
    return _CHAR_TO_CODE[np.frombuffer(s, dtype=np.uint8)]

def decode_seq(codes: np.ndarray) -> bytes:
    return CODE_TO_CHAR[codes].tobytes()

def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code array (N maps to N)."""
    out = codes[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out

# ---- index geometry defaults (values match reference defaults where they
# ---- are user-visible: offrate 5, ftabchars 10; block size is ours) ----
OFF_RATE = 4                 # SA sampled every 2^4 = 16 text positions: the
                             # resolve walk is scan-step-bound on TPU, so a
                             # denser sample (vs the reference default 5)
                             # halves its steps for modest offs[] memory
FTAB_CHARS = 10              # ftab lookup prefix length (bt2_idx.h ftabChars)
OCC_BLOCK = 128              # bases per occ checkpoint block
WORDS_PER_BLOCK = OCC_BLOCK // 16   # 16 bases per uint32 word
