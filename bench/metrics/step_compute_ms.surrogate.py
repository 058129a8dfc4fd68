"""Mean time of a window step's compute, to the host copy of its loss (Trainer.step_times compute_s)."""
from bench import readers

LAYER = "model step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.mean_ms(r, "compute_s")
