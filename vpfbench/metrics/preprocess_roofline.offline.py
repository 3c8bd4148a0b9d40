"""The pre-processing's share of its roofline: the least time of its work
(YUV420 read once and normalised float32 written once over the memory
rate, or its FLOPs over the float32 rate if longer), over the device time
of the kernels launched inside the benchmark's ``vpfbench.preprocess``
ranges, in %."""

from .roofline import preprocess


def read(record):
    return preprocess(record)
