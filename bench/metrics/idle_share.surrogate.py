"""Share of the traced window in which no operation ran on the device (the union of device intervals)."""
from bench import readers

LAYER = "device"
UNIT = "ratio"
SOURCE = "device_trace"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.idle_share(r)
