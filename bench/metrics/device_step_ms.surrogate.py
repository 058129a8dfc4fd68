"""Device time of a traced step (the union of device intervals over the traced steps): the card's work, steady where the host's pace is not."""
from bench import readers

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.device_step_ms(r)
