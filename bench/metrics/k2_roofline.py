"""Flash attention's (K2) least time at the cell's microbatch, forward and backward, over its kernels' device time in the trace."""
from bench import readers

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_tokens_per_s"
BETTER = "higher"


def read(r):
    return readers.k2_roofline(r)
