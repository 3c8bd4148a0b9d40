"""The ring feed's ``dispatch`` stage (staging copy into pinned memory,
upload enqueue, pre-processing enqueue), mean ms a batch over the
window's batches that ran before the profiler first started, from the
port's own ``StageTimer`` on the host clock."""

from .batches import mean_ms


def read(record):
    return mean_ms(record, 3)
