"""End to end: the card's busy time over the whole window, from the window's own device trace, per weighted sample trained in it."""
from bench import readers

UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"


def read(r):
    return readers.device_ms_per_unit(r)
