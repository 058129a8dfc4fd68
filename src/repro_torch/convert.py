"""Carry parameters across from the JAX package.

``params_from_jax`` takes a JAX parameter pytree whose leaves were turned
into numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
same nested dict of torch tensors, leaf names and layouts unchanged.

JAX's bf16 leaves arrive as numpy arrays of ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses and which the port does not import.  They are
recognised by dtype name and carried through a 16-bit integer view, bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """One numpy leaf (including ``ml_dtypes.bfloat16``) to a CPU tensor.
    Copies: numpy views of JAX arrays are read-only, and torch tensors are
    not."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf with itemsize {a.dtype.itemsize}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, device, dtype: torch.dtype | None = None):
    """Nested dict of numpy leaves -> nested dict of tensors on ``device``.
    With ``dtype``, floating-point leaves are cast to it."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    t = tensor_from_numpy(np.asarray(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)
