"""The window's batches that ran before the profiler first started."""


def unprofiled(record) -> list:
    """(seconds, frames, model enqueue s, feed dispatch s) of each batch
    of the window that ended before the profiler first started (or
    outside ``record.profiled`` as a rule), its seconds from the end of
    the batch before it to its own end: the traced run's batches that
    ran as an untraced run's do."""
    out, prev = [], record.t_window0
    for end, frames, enqueue, dispatch in record.batches:
        if not any(a < end and prev < b for a, b in record.profiled):
            out.append((end - prev, frames, enqueue, dispatch))
        prev = end
    return out


def mean_ms(record, k: int):
    """Mean ms a batch of field ``k`` of :func:`unprofiled` (2: model
    enqueue, 3: feed dispatch), or None without such batches."""
    batches = unprofiled(record)
    if not batches:
        return None
    return 1e3 * sum(b[k] for b in batches) / len(batches)


def frames_per_s(record):
    """Frames over seconds of the unprofiled batches, or None."""
    batches = unprofiled(record)
    seconds = sum(b[0] for b in batches)
    frames = sum(b[1] for b in batches)
    if not frames or seconds <= 0:
        return None
    return frames / seconds
