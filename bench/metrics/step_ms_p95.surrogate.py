"""The 95th percentile of every window step's wall time (the trainer's wait, load and compute of each step)."""
from bench import readers

LAYER = "entry"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.step_p95_ms(r)
