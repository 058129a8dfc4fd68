"""Distributed training helpers (the numeric half of gradient compression)."""
