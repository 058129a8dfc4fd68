"""Physical store reads (the store's read_calls, each paying the emulated PFS latency) per window step."""
from bench import readers

LAYER = "loader"
UNIT = "count"
SOURCE = "program_counter"
MOVES = "device_ms_per_sample"
BETTER = "lower"


def read(r):
    return readers.pfs_reads_per_step(r)
