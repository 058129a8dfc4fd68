"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Mirrors ``repro``'s module paths.  Imports torch and numpy only: nothing of
JAX and nothing of ``repro``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; see :func:`resolve_device`.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
