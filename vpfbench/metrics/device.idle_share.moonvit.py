"""``device.idle_share.offline``'s reading in the MoonViT cell: % of the
profiled wall time with no kernel running on the device."""

from .idle import share


def read(record):
    return share(record)
