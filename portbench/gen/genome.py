"""A configuration's genome: its references, made by the recipe that
its `genome` entry names (portbench/gen/genomes/<recipe>.py, found by
the name) from the entry's fixed seed, and joined into one sequence for
the read recipes and the reference.

A recipe file defines `make(rng, refs)`: refs is the entry's list of
[name, bp], and it returns [(name, codes)] in that order, codes 0..3
(A, C, G, T) and 4 (N). A new recipe is a new file.
"""

import numpy as np

from portbench import manifest

PAD = 1024          # N codes between two references in the joined sequence


def recipe_file(spec):
    """The file of the recipe a configuration's `genome` entry names."""
    return manifest.plug_file("gen/genomes", spec["recipe"])


def make_refs(spec):
    """[(name, uint8 codes)] of a configuration's `genome` entry."""
    rng = np.random.default_rng(spec["seed"])
    refs = manifest.plug("gen/genomes", spec["recipe"]).make(
        rng, spec["refs"])
    names = [n for n, _c in refs]
    if names != [n for n, _bp in spec["refs"]]:
        raise ValueError(f"recipe {spec['recipe']} made {names}")
    return [(n, np.asarray(c).astype(np.uint8)) for n, c in refs]


class Genome:
    """References joined in order with PAD Ns between them: `codes` is the
    joined sequence (uint8; the one reference itself where there is one),
    `starts[i]` where reference i begins in it. Reads carry their origin
    as a position in `codes`; a SAM record's (RNAME, POS) maps to one by
    `start(RNAME) + POS - 1`."""

    def __init__(self, refs):
        self.names = [n for n, _c in refs]
        self.lens = np.array([c.size for _n, c in refs], np.int64)
        self.starts = np.concatenate(
            [[0], np.cumsum(self.lens[:-1] + PAD)]).astype(np.int64)
        if len(refs) == 1:
            self.codes = np.asarray(refs[0][1], np.uint8)
        else:
            self.codes = np.full(int(self.starts[-1] + self.lens[-1]), 4,
                                 np.uint8)
            for s, (_n, c) in zip(self.starts, refs):
                self.codes[s:s + c.size] = c
        self._at = {n: i for i, n in enumerate(self.names)}

    @property
    def size(self):
        return self.codes.size

    def refs(self):
        """[(name, codes)] of the references, as the index is built."""
        return [(n, self.codes[s:s + ln])
                for n, s, ln in zip(self.names, self.starts, self.lens)]

    def bounds(self, name):
        """(start, end) of a reference in `codes`; KeyError for a name
        that is not one of them."""
        i = self._at[name]
        return int(self.starts[i]), int(self.starts[i] + self.lens[i])

    def locate(self, pos):
        """(name, 0-based position in it) of a position of `codes`."""
        i = int(np.searchsorted(self.starts, pos, side="right")) - 1
        return self.names[i], int(pos - self.starts[i])

    def draw_starts(self, rng, n, span):
        """Start positions in `codes` of n reads (n None: one, as an int)
        that each cover `span` bases of one reference. With one
        reference: uniform in [0, size - span), drawn as
        rng.integers(0, size - span, n)."""
        if len(self.names) == 1:
            return rng.integers(0, self.size - span, n)
        room = np.maximum(self.lens - span, 0)
        k = 1 if n is None else n
        ref = rng.choice(len(room), k, p=room / room.sum())
        out = self.starts[ref] + (rng.random(k) * room[ref]).astype(np.int64)
        return int(out[0]) if n is None else out
