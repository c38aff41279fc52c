"""The one generator of every traffic mix: a mix is a JSON file of
parameters under portbench/traffic/ that names a read recipe
(portbench/gen/reads/<recipe>.py, found by the name: `draw(rng, genome,
n, params)`), and batch k of a run is drawn from the run's seed and k
alone, so the same seed gives the same reads and no read is ever sent
twice."""

import numpy as np

from portbench import manifest

WINDOW, WARM = 1, 0      # the two read streams of a run


class Traffic:
    """Batches of units (reads, or pairs of reads) of one mix over one
    genome (gen/genome.py Genome). `batch(k)` is the k-th batch of the
    run's window stream; `warm(k)` of its warm-up stream, which shares no
    read with it."""

    def __init__(self, spec, genome, seed):
        self.spec = spec
        self.genome = genome
        self.seed = int(seed) % (1 << 64)
        self.size = int(spec["batch"])
        self._draw = manifest.plug("gen/reads", spec["recipe"]).draw

    def _batch(self, stream, k):
        rng = np.random.default_rng([self.seed, stream, k])
        return self._draw(rng, self.genome, self.size, self.spec)

    def batch(self, k):
        return self._batch(WINDOW, k)

    def warm(self, k):
        return self._batch(WARM, k)
