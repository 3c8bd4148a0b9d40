"""MoonViT's attention share of its roofline: the scores' and weighted
values' FLOPs (``models/kimi_vl_moonvit.py`` ``attention_flops_per_frame``
at the record's output size) of the frames the device stretches ran, over
the device time there of the kernels whose names hold one of its
``ATTENTION_KERNELS`` × the card's bf16 dense peak, in %. At 4,096
patches a frame the FLOPs bound, not the bytes of q, k, v and the output.

The stretches' frames: their kernels' device seconds (copies left out)
over the device seconds a frame of the calls in the host stretches, the
``vpfbench.model`` and ``vpfbench.preprocess`` calls together (every
kernel of the window runs inside one of them). A kernel is picked by name
because inside a CUDA graph every kernel carries the graph launch's
correlation id."""

from ..harness import HERE, load_module, read_json
from ..tracing import _is_copy


def read(record):
    t = record.trace
    if t is None:
        return None
    model = load_module(HERE / "models" / "kimi_vl_moonvit.py", "models")
    calls, pre = t.device_s("model"), t.device_s("preprocess")
    kernels = {n: s for n, s in t.ops.items() if not _is_copy(n)}
    attention = sum(s for n, s in kernels.items()
                    if any(f in n for f in model.ATTENTION_KERNELS))
    if not calls or sum(calls) <= 0 or attention <= 0:
        return None
    batch_s = sum(calls) / len(calls) + (sum(pre) / len(pre) if pre else 0.0)
    frames = sum(kernels.values()) * record.params["batch"] / batch_s
    cfg = read_json(HERE / "configs" / "kimi_vl_moonvit.json")
    flops = model.attention_flops_per_frame(
        dict(cfg, image_size=record.params["out_size"])) * frames
    return 100.0 * flops / (attention * record.rates["bf16"])
