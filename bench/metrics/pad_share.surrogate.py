"""Rows computed with weight 0 (SOLAR's capacity padding) over rows computed in the window."""
from bench import readers

LAYER = "loader"
UNIT = "ratio"
SOURCE = "program_counter"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.pad_share(r)
