"""The comparison's draws: seeded samples, and a gap that reads rows of
other frames."""

import numpy as np

from vpfbench.check import Reservoir, logit_gap


def test_reservoir_is_seeded_and_uniform():
    def draw(seed):
        r = Reservoir(3, np.random.default_rng(seed))
        for i in range(1000):
            r.offer(lambda i=i: i)
        return r.items

    assert draw(5) == draw(5) and draw(5) != draw(6)
    counts = np.zeros(10)
    for s in range(2000):
        r = Reservoir(1, np.random.default_rng(s))
        for i in range(10):
            r.offer(lambda i=i: i)
        counts[r.items[0]] += 1
    assert counts.min() > 140


def test_logit_gap_reads_rows_of_other_frames():
    rng = np.random.default_rng(0)
    import torch

    want = torch.from_numpy(rng.normal(size=(64, 1000)))
    assert logit_gap(want, want) == 0
    assert logit_gap(want.roll(1, 0), want) > 3
