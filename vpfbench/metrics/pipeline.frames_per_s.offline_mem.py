"""Frames a second of the whole offline path (ring feed, pre-processing,
model) over the window's batches that ran before the profiler first
started, on the host clock: ``frames_per_s`` of an untraced run, read
per layer in the cells where the host's swings leave it no bound."""

from .batches import frames_per_s


def read(record):
    return frames_per_s(record)
