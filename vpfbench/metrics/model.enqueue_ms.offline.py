"""Host time of the benchmark's call of the model's forward, mean ms a
batch over the window's batches that ran before the profiler first
started (host clock): the eager enqueue of its kernels."""

from .batches import mean_ms


def read(record):
    return mean_ms(record, 2)
