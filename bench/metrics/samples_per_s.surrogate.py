"""The window's weighted samples over its whole wall time: the surrogate's training rate, paced by the host (kept per layer, its spread between runs being wider than a bound can hold)."""
from bench import readers

LAYER = "entry"
UNIT = "samples/s"
SOURCE = "host_clock"
MOVES = "device_ms_per_sample"
BETTER = "higher"


def read(r):
    return readers.window_rate(r)
