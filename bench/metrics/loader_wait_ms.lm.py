"""Mean time a window step waits for the loader's next planned batch (Trainer.step_times wait_s)."""
from bench import readers

LAYER = "trainer"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "train_tokens_per_s"
BETTER = "lower"


def read(r):
    return readers.mean_ms(r, "wait_s")
