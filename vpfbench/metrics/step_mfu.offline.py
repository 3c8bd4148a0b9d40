"""The whole step's share of the card's bf16 dense peak: the FLOPs of the
model (counted from the configuration's shapes) and of the
pre-processing, for the frames of the window's batches that ran before
the profiler first started, over those batches' host-clock time, in %:
the traced run reads the rate of an untraced one."""

from .mfu import step


def read(record):
    return step(record)
