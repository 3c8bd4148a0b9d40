"""The system under test as the window drives it: the port's
``FusedPipeline`` (resize + colour conversion + normalisation) and the
configuration's model. The lower-precision control (control.py) and the
faults of the harness's tests put other objects in its place."""

from __future__ import annotations


class Program:
    def pipeline(self, params: dict, device):
        """``fn(y, u, v)`` → (N, out, out, 3) normalised float32 from
        planar YUV420."""
        from videoprocessingframework_torch.core.enums import (
            ColorRange,
            ColorSpace,
            PixelFormat,
        )
        from videoprocessingframework_torch.ops.fused import FusedPipeline

        out = params["out_size"]
        return FusedPipeline(
            PixelFormat.YUV420, ColorSpace[params["color_space"]],
            ColorRange[params["color_range"]], (out, out),
            output="normalized", device=device, kernel=params["kernel"])

    def model(self, model_module, cfg: dict, weights: dict):
        """``fn(x)``: (N, H, W, 3) → (N, classes) float32 logits."""
        return model_module.build(cfg, weights)
