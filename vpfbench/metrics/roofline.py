"""The pre-processing's share of its roofline over the traced calls."""

from ..yardstick import preprocess_least_s


def preprocess(record):
    """The least time of the traced calls' work (their requests' frames,
    not the padding), over the device time of the kernels those calls
    launched, in %."""
    if record.trace is None:
        return None
    calls = record.trace.device_s("preprocess")
    frames = record.preprocess_frames
    if not calls or len(calls) != len(frames) or sum(calls) <= 0:
        return None
    p = record.params
    least = sum(preprocess_least_s(n, p["height"], p["width"],
                                   p["out_size"], p["out_size"],
                                   record.rates) for n in frames)
    return 100.0 * least / sum(calls)
