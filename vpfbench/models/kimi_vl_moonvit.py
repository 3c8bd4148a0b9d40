"""Kimi-VL-A3B's MoonViT vision tower and projector through the port's
``models.moonvit.MoonViT`` in bfloat16 at the published widths and 27
blocks; its weights from the seed; its FLOPs a frame, all of them and the
attention's; and the names of the attention kernels, for the reader of
``model.attention_roofline.moonvit``.

A frame's "logits" here are its visual tokens, (tokens, 2048) flattened
to one row, so that the comparison and its faults treat them as the
other configurations' class logits.
"""

from __future__ import annotations

import json
import sys

from . import common

#: fragments of the names of the fused attention kernels that
#: ``F.scaled_dot_product_attention`` launches on an H100: cuDNN's
#: (``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_...``), flash's
#: (``pytorch_flash::flash_fwd_kernel<...>``) and the memory-efficient one
#: (``fmha_cutlassF_...``)
ATTENTION_KERNELS = ("_sdpa_", "flash_fwd_kernel", "fmha_cutlassF")


def _widths(cfg):
    v = cfg["vision_config"]
    return (v["patch_size"], v["hidden_size"], v["intermediate_size"],
            tuple(v["merge_kernel_size"]), cfg["hidden_size"])


def _leaves(cfg):
    v = cfg["vision_config"]
    p, d, m, (mh, mw), out = _widths(cfg)
    merged = d * mh * mw

    def dense(name, cin, cout):
        return [(f"{name}.weight", (cout, cin), common.normal(cin ** -0.5)),
                (f"{name}.bias", (cout,), common.normal(0.02))]

    def norm(name):
        return [(f"{name}.weight", (d,), common.around(1.0, 0.1)),
                (f"{name}.bias", (d,), common.normal(0.02))]

    leaves = [("patch_embed.weight", (d, 3, p, p),
               common.normal((3 * p * p) ** -0.5)),
              ("patch_embed.bias", (d,), common.normal(0.02)),
              ("pos_emb", (v["init_pos_emb_height"], v["init_pos_emb_width"],
                           d), common.normal(0.1))]
    for i in range(v["num_hidden_layers"]):
        b = f"blocks.{i}"
        leaves += norm(f"{b}.norm0") + dense(f"{b}.wqkv", d, 3 * d)
        leaves += dense(f"{b}.wo", d, d) + norm(f"{b}.norm1")
        leaves += dense(f"{b}.fc0", d, m) + dense(f"{b}.fc1", m, d)
    return (leaves + norm("final_layernorm") + norm("pre_norm")
            + dense("linear_1", merged, merged)
            + dense("linear_2", merged, out))


def weights(cfg: dict, seed: int, device) -> dict:
    return common.make(_leaves(cfg), seed, device)


class Tokens:
    """The program's call: the model's (N, tokens, width) visual tokens as
    (N, tokens·width) rows (a view). Prints the model's ``vision_stats``
    and ``graph_stats`` on standard error once the first replay has run
    (the end of the model's set-up: its eager runs and capture) and again
    when the run lets the model go, after the window."""

    def __init__(self, model):
        self.model = model
        self.said = False

    def __call__(self, x):
        out = self.model(x)
        if not self.said and self.model.graph_stats["replays"]:
            self.said = True
            self.say("after the capture")
        return out.flatten(1)

    def say(self, when: str) -> None:
        print(f"vision_stats {when}: {json.dumps(self.model.vision_stats)}; "
              f"graph_stats: {json.dumps(self.model.graph_stats)}",
              file=sys.stderr, flush=True)

    def __del__(self):
        self.say("when released")


def build(cfg: dict, weights: dict):
    """The port's model on the weights' device, in inference mode."""
    import torch
    from videoprocessingframework_torch.models.moonvit import MoonViT

    v = cfg["vision_config"]
    p, d, m, merge, out = _widths(cfg)
    with torch.device("meta"):
        model = MoonViT(patch=p, dim=d, depth=v["num_hidden_layers"],
                        heads=v["num_attention_heads"], mlp_dim=m,
                        pos_grid=(v["init_pos_emb_height"],
                                  v["init_pos_emb_width"]),
                        merge=merge, out_dim=out, eps=v["layer_norm_eps"],
                        rope_theta=v["rope_theta"],
                        dtype=common.DTYPES[cfg["dtype"]])
    return Tokens(common.load(model, weights))


def _macs(cfg):
    """Multiply-adds a frame at ``cfg["image_size"]``: (patch embedding,
    one block's projections and MLP, one block's scores and weighted
    values, the projector)."""
    p, d, m, (mh, mw), out = _widths(cfg)
    length = (cfg["image_size"] // p) ** 2
    merged = d * mh * mw
    return (length * 3 * p * p * d,
            4 * length * d * d + 2 * length * d * m,
            2 * length * length * d,
            length // (mh * mw) * (merged * merged + merged * out))


def flops_per_frame(cfg: dict) -> float:
    """2 × the multiply-adds of the patch embedding, the QKV and output
    projections, the attention scores and weighted values, the MLP and
    the projector (norms, RoPE, softmax, GELU, the merge and the residual
    sums left out): 5.52e12 at 896²."""
    embed, block, attention, head = _macs(cfg)
    layers = cfg["vision_config"]["num_hidden_layers"]
    return 2.0 * (embed + layers * (block + attention) + head)


def attention_flops_per_frame(cfg: dict) -> float:
    """2 × the multiply-adds of the scores and the weighted values over a
    frame's own patches, every block: 2.087e12 at 896²."""
    return 2.0 * cfg["vision_config"]["num_hidden_layers"] * _macs(cfg)[2]
