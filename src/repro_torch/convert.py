"""Carry parameters across from the JAX package, and back.

``params_from_jax`` takes a JAX parameter pytree whose leaves were turned
into numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
same nested dict of torch tensors, leaf names and layouts unchanged: the
language models keep the JAX layout.

The CNN surrogates do not: their convolution weights are in PyTorch's layout
(:mod:`repro_torch.models.cnn`).  ``surrogate_params_from_jax`` and
``surrogate_params_to_jax`` map the JAX tree ``{"enc": [{"w", "b"}, ...],
"dec": [...], "head": None | {"w1", "b1", "w2", "b2"}}`` to the port's flat
dict (``enc.0.w``, ...) and back; ``surrogate_leaf_from_jax`` /
``surrogate_leaf_to_jax`` do it leaf by leaf, for optimizer moments and
checkpoints too.  Encoder kernels go from HWIO / DHWIO to OIHW / OIDHW.
The decoder's transposed-convolution kernels are flipped spatially and laid
out ``[in, out, ...]``.  Both maps only move elements, so a round trip is
bit for bit.

JAX's bf16 leaves arrive as numpy arrays of ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses and which the port does not import.  They are
recognised by dtype name and carried through a 16-bit integer view, bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax", "tensor_from_numpy", "tensor_to_numpy",
           "from_jax_layout", "to_jax_layout",
           "surrogate_leaf_from_jax", "surrogate_leaf_to_jax",
           "surrogate_params_from_jax", "surrogate_params_to_jax"]


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


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor to a host numpy array.  bf16 has no numpy dtype without
    ``ml_dtypes``, so it is widened to f32, which holds every bf16 value."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.contiguous().numpy()


def _conv_kind(name: str) -> str | None:
    """``"conv"``, ``"convt"`` or None for a flat surrogate leaf name."""
    part, _, leaf = name.rpartition(".")
    if leaf != "w":
        return None
    if part.startswith("enc."):
        return "conv"
    if part.startswith("dec."):
        return "convt"
    return None


def from_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """A surrogate leaf in the JAX layout to the port's, on its device."""
    kind = _conv_kind(name)
    if kind is None:
        return t
    rank = t.ndim - 2
    spatial = tuple(range(rank))
    if kind == "conv":  # (k.., I, O) -> (O, I, k..)
        return t.permute(rank + 1, rank, *spatial).contiguous()
    # transposed: flip the kernel, (k.., I, O) -> (I, O, k..)
    return t.flip(spatial).permute(rank, rank + 1, *spatial).contiguous()


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`from_jax_layout`, on the tensor's device."""
    kind = _conv_kind(name)
    if kind is None:
        return t
    rank = t.ndim - 2
    spatial = tuple(range(2, rank + 2))
    if kind == "conv":  # (O, I, k..) -> (k.., I, O)
        return t.permute(*spatial, 1, 0).contiguous()
    # (I, O, k..) -> (k.., I, O), flipped back
    return t.permute(*spatial, 0, 1).flip(tuple(range(rank))).contiguous()


def surrogate_leaf_from_jax(name: str, a) -> torch.Tensor:
    """A JAX-layout surrogate leaf (numpy) to the port's layout (CPU tensor)."""
    return from_jax_layout(name, tensor_from_numpy(np.asarray(a)))


def surrogate_leaf_to_jax(name: str, t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`surrogate_leaf_from_jax`, to a numpy array."""
    return tensor_to_numpy(to_jax_layout(name, t.detach()))


def _flat_jax_tree(tree) -> dict:
    out = {}
    for part in ("enc", "dec"):
        for i, layer in enumerate(tree.get(part) or []):
            for leaf, a in layer.items():
                out[f"{part}.{i}.{leaf}"] = a
    for leaf, a in (tree.get("head") or {}).items():
        out[f"head.{leaf}"] = a
    return out


def surrogate_params_from_jax(tree, device, dtype: torch.dtype | None = None
                              ) -> dict[str, torch.Tensor]:
    """JAX surrogate params (numpy leaves) -> the port's flat dict on
    ``device``, every convolution kernel in PyTorch's layout."""
    out = {}
    for name, a in _flat_jax_tree(tree).items():
        t = surrogate_leaf_from_jax(name, a)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t.to(device)
    return out


def surrogate_params_to_jax(params) -> dict:
    """The port's flat surrogate dict -> the JAX tree of numpy leaves."""
    tree: dict = {"enc": [], "dec": [], "head": None}
    for name, t in params.items():
        a = surrogate_leaf_to_jax(name, t)
        part, *rest = name.split(".")
        if part == "head":
            tree["head"] = tree["head"] or {}
            tree["head"][rest[0]] = a
            continue
        i, leaf = int(rest[0]), rest[1]
        while len(tree[part]) <= i:
            tree[part].append({})
        tree[part][i][leaf] = a
    return tree
