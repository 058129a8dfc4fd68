"""Model FLOPs of the window's weighted samples (3 x the convolutions' and head's forward) over the window's time and the TF32 dense peak."""
from bench import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "device_ms_per_sample"
BETTER = "higher"


def read(r):
    return readers.mfu_percent(r)
