"""The device's idle share over the traced stretches."""


def share(record):
    """% of the traced wall time in which no kernel ran (copies are not
    kernels)."""
    t = record.trace
    if t is None or t.window_s <= 0 or t.kernel_s <= 0:
        return None
    return 100.0 * (1.0 - t.kernel_s / t.window_s)
