"""Faults planted under the timed path, to show that a run which has
them comes out not correct (portbench/tests/test_pb_faults.py on the
CPU; `python3 -m portbench.control --fault <name>` on the card at a
cell's own size). Each takes the aligner and breaks its `collect_raw`."""


def drop_half(al):
    """Half of each batch's records left out."""
    inner = al.collect_raw

    def collect_raw(h, suffix=b""):
        groups = inner(h, suffix)
        return groups[:len(groups) // 2]
    al.collect_raw = collect_raw


def shift_positions(al):
    """Every aligned record's POS one base off, as produced."""
    inner = al.collect_raw

    def collect_raw(h, suffix=b""):
        out = []
        for group in inner(h, suffix):
            g = []
            for flag, line in group:
                f = line.split(b"\t")
                if not flag & 4:
                    f[3] = str(int(f[3]) + 1).encode()
                g.append((flag, b"\t".join(f)))
            out.append(g)
        return out
    al.collect_raw = collect_raw


FAULTS = {"drop_half": drop_half, "shift_positions": shift_positions}
