"""``device.idle_share.offline``'s reading, in the offline cells whose end-to-end
metric besides the set-up is the window's device-memory peak."""

from .offline_mem import reader

read = reader("device.idle_share.offline")
