"""``model.mfu.offline``'s reading in the MoonViT cell: the model's FLOPs
for the frames of the traced calls over the device time of the kernels
those calls launched inside ``vpfbench.model``, in % of the bf16 peak."""

from .mfu import model


def read(record):
    return model(record)
