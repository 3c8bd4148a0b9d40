"""The model's share of the card's bf16 dense peak while it runs: its
FLOPs (counted from the configuration's shapes) for the frames of the
traced calls, over the device time of the kernels those calls launched
inside the benchmark's ``vpfbench.model`` range, in %. A change to the
feed or the pre-processing leaves it where it is."""

from .mfu import model


def read(record):
    return model(record)
