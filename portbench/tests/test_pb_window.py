"""The window's rule: drive the CLI's pattern until the first collect
that returns after the window's length, and count every unit of every
batch collected over the time to that return."""

from portbench.window import drive, rate


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_ends_at_first_collect_past_length():
    clock = Clock()
    submitted, collected = [], []

    def submit(recs):
        clock.t += 0.1
        submitted.append(recs)
        return recs

    def collect(h):
        clock.t += 1.0
        collected.append(h)
        return [("g", x) for x in h]

    def batch_at(k):
        units = list(range(10 * k, 10 * k + 10))
        return units, [f"n{u}" for u in units], units

    got, pend, t0, t1, marks = drive(submit, collect, batch_at, 3, 5.0,
                                     clock)
    # submits 1-4 (0.4 s), then collect + submit alternate (1.1 s each)
    assert t0 == 100.0
    assert t1 - t0 >= 5.0 and t1 - t0 - 1.1 < 5.0
    assert len(got) == len(collected) == len(submitted) - 3
    assert len(pend) == 3
    assert len(marks) == len(got) and marks[-1] == t1
    assert [u for u, _g, _n in got] == [list(range(10 * k, 10 * k + 10))
                                        for k in range(len(got))]
    assert rate(got, t0, t1) == 10 * len(got) / (t1 - t0)


def test_rate_counts_units_not_batches():
    got = [([1, 2, 3], [], []), ([4], [], [])]
    assert rate(got, 0.0, 2.0) == 2.0


def test_a_run_past_its_read_pool_says_so(tiny, tmp_path):
    """Batches the window had to make itself are counted in the result,
    and a run within its pool counts none."""
    from portbench.run import run_cell

    for pool, made in ((0, True), (40, False)):
        cell = tiny("se")
        cell.traffic["pool_batches"] = pool
        out = run_cell(cell, 9, 0.05, 0, device="cpu", cache=str(tmp_path))
        assert out["correct"], out["checks"]
        assert (out["batches_made_in_window"] >= 4) is made
        assert list(out)[-1] == "checks"


def test_a_mix_can_pin_the_allocator():
    from portbench.run import pin_allocator

    assert pin_allocator({}) is None
    want = {"mmap_threshold": 32 << 20, "trim_threshold": 64 << 20}
    assert pin_allocator({"malloc": want}) == want
