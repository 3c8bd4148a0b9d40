"""Shares of the card's bf16 dense peak."""

from ..yardstick import preprocess_work
from .batches import frames_per_s


def model(record):
    """The model's FLOPs (counted from the configuration's shapes) for
    the frames of the traced calls, over the device time of the kernels
    those calls launched inside the benchmark's ``vpfbench.model`` range,
    in % of the peak."""
    if record.trace is None:
        return None
    calls = record.trace.device_s("model")
    if not calls or sum(calls) <= 0:
        return None
    frames = record.params["batch"] * len(calls)
    return 100.0 * record.flops_per_frame * frames / (
        sum(calls) * record.rates["bf16"])


def step(record):
    """The FLOPs of the model and of the pre-processing for the frames of
    the unprofiled batches, over those batches' host-clock time, in % of
    the peak."""
    rate = frames_per_s(record)
    if rate is None:
        return None
    p = record.params
    per_frame = record.flops_per_frame + preprocess_work(
        1, p["height"], p["width"], p["out_size"], p["out_size"])[1]
    return 100.0 * per_frame * rate / record.rates["bf16"]
