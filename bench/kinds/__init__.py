"""What differs between kinds of model, one module each, found by the
configuration file's ``kind``: how the port's launcher builds the training
step and batches, what the reference computes for one step's rows, the
end-to-end rate a cell of the kind reports and the model FLOPs of a row."""
from __future__ import annotations

import importlib


def get(kind: str):
    return importlib.import_module(f"bench.kinds.{kind}")
