"""Mean time a window step takes to assemble its padded batch and stage it to the card (train.make_batch: to_global and the pinned copy)."""
from bench import readers

LAYER = "trainer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.mean_ms(r, "load_s")
