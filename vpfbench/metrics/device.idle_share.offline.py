"""% of the profiled wall time with no kernel running on the device
(torch.profiler, a few stretches spread through the window)."""

from .idle import share


def read(record):
    return share(record)
