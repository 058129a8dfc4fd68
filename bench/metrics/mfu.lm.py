"""Model FLOPs of the window's weighted rows (6 N tokens plus windowed attention) over the window's time and the bf16 dense peak."""
from bench import readers

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(r):
    return readers.mfu_percent(r)
