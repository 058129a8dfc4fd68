"""Sharding rules: logical param/activation layouts -> DTensor placements.

Port of ``repro.distributed.sharding`` (DESIGN.md §5):
  * mesh axes ``(pod, data, model)`` (multi-pod) or ``(data, model)``, a
    ``torch.distributed`` ``DeviceMesh`` whose ``mesh_dim_names`` are the
    axis names (``launch.mesh``);
  * params are FSDP-sharded over ``data`` (and ``pod``) on one dim and over
    ``model`` on another;
  * rules are *candidate lists*: the first spec whose every mesh-axis
    assignment divides the dim is used, so architectures with awkward
    head/vocab counts (Hymba's 25 heads, Whisper's 51865 vocab) degrade to
    partial sharding.

A spec (:class:`PartitionSpec`) holds one entry per tensor dim, as JAX's
does: ``None``, an axis name, or a tuple of names.  :func:`to_placements`
turns it into one DTensor placement per mesh dim: ``Shard(i)`` on every
mesh dim named for tensor dim ``i``, ``Replicate()`` elsewhere.  A tuple
entry ``("pod", "data")`` shards the dim over both, pod-major, as JAX's
combined entries do (DTensor splits a dim over its mesh dims in mesh order).

The engine reads only axis names and sizes, so it takes a ``DeviceMesh`` or
any object with ``axis_names`` and ``devices.shape`` (or ``axis_sizes``),
as the JAX tests' fake meshes have.  Leaf names are the port's flat names
(``layers.ssm.in_proj``, ``enc_layers.attn.wq``): the rules' patterns match
the ends of names and hold no separator, so they pick the same leaves as on
JAX's ``/``-joined paths, in the same order (``unembed$`` before
``embed$``, the attention ``wo$`` before the MLP's).

JAX's activation constraints (``constrain``, ``constrain_batch``) have no
counterpart: the sharded train step hands the model plain tensors
(``distributed/fsdp.py``), so an activation is never a DTensor.  Where
JAX's constraints pin heads, MLP hidden or channels over ``model``, the
port splits that compute explicitly (``distributed/tensor_parallel.py``):
:func:`tp_split_dim` names the dim each rule's leaves split on, and a part
of the model splits where the chosen spec puts ``model`` on it.
"""
from __future__ import annotations

import dataclasses
import math
import re

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "choose_spec",
    "to_placements",
    "param_sharding",
    "batch_sharding",
    "cache_sharding",
    "tp_split_dim",
    "names_axis",
]

# fsdp dims shard over every data-parallel axis present (pod included)
FSDP = ("pod", "data")
TP = "model"


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh axis name, or a tuple of
    names (the dim split over all of them, in that order).  A tuple of one
    name is that name, and an empty one None, as in JAX's."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, tuple) and len(e) < 2:
                return e[0] if e else None
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)


def _names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    if names is None:
        raise ValueError("the mesh has no axis names (build it with mesh_dim_names)")
    return tuple(names)


def _axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a JAX-style mesh."""
    if getattr(mesh, "mesh_dim_names", None) is not None:  # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        sizes = mesh.devices.shape
    return dict(zip(mesh.axis_names, sizes))


def _fits(shape, spec, sizes) -> bool:
    for dim, assignment in zip(shape, spec):
        if assignment is None:
            continue
        names = assignment if isinstance(assignment, tuple) else (assignment,)
        if dim % math.prod(sizes[n] for n in names) != 0:
            return False
    return True


def choose_spec(shape, candidates, mesh) -> PartitionSpec:
    """First candidate spec that divides ``shape`` on this mesh (else replicate).

    Axis names absent from the mesh are dropped from each assignment (so the
    same rules serve the single-pod and multi-pod meshes), and within a
    combined assignment, axes that stop dividing the dim are dropped
    greedily.
    """
    sizes = _axes(mesh)
    for spec in candidates:
        spec = tuple(spec)[: len(shape)]
        cleaned = []
        for dim, assignment in zip(shape, spec + (None,) * (len(shape) - len(spec))):
            if assignment is None:
                cleaned.append(None)
                continue
            names = assignment if isinstance(assignment, tuple) else (assignment,)
            keep, total = [], 1
            for n in names:
                if n in sizes and dim % (total * sizes[n]) == 0:
                    keep.append(n)
                    total *= sizes[n]
            cleaned.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
        spec = P(*cleaned)
        if _fits(shape, spec, sizes):
            return spec
    return P(*([None] * len(shape)))


# Per-leaf candidate specs, keyed by regex on the leaf name, written for the
# UNSTACKED tensor — the leading layer axis (None) is prepended for stacked
# leaves.  Earlier entries are preferred; axes that do not exist on the mesh
# or do not divide the dim are dropped per-entry.
_RULES: list[tuple[str, list[tuple]]] = [
    # embeddings / output head (unembed first: 'embed$' also matches it).
    # Vocab over TP only: sharding d over 'data' too would make the token
    # gather's partial sum produce batch-replicated activations.
    (r"unembed$", [(None, TP), (FSDP, None), ()]),
    (r"embed$", [(TP, None), (None, FSDP), ()]),
    (r"mm_proj$", [(FSDP, TP), ()]),
    # attention
    (r"(wq|wk|wv)$", [(FSDP, TP, None), (TP, None, None), (FSDP,), ()]),
    (r"wo$", [(TP, None, FSDP), (None, None, FSDP), ()]),
    (r"(bq|bk|bv)$", [(TP, None), ()]),
    # dense / shared-expert MLPs
    (r"(wi_gate|wi_up|ws_gate|ws_up|wi)$", [(FSDP, TP), (None, TP), ()]),
    (r"(wo_mlp|ws_down|wo)$", [(TP, FSDP), (TP, None), ()]),
    (r"bi$", [(TP,), ()]),
    (r"bo$", [()]),
    # MoE experts: expert-parallel over model axis, FSDP over d.
    (r"router$", [(FSDP, None), ()]),
    (r"we_(gate|up)$", [(TP, FSDP, None), (TP, None, None), ()]),
    (r"we_down$", [(TP, None, FSDP), (TP, None, None), ()]),
    # Mamba / SSM
    (r"in_proj$", [(FSDP, TP), (None, TP), ()]),
    (r"conv_w$", [(None, TP), ()]),
    (r"(conv_b|dt_bias|d_skip)$", [(TP,), ()]),
    (r"x_proj$", [(TP, None), ()]),
    (r"dt_proj$", [(None, TP), ()]),
    (r"a_log$", [(TP, None), ()]),
    (r"out_proj$", [(TP, FSDP), (TP, None), ()]),
    # norms and everything else: replicated
    (r"(ln|norm|scale|bias)", [()]),
]

# Leaves that are NOT layer-stacked (no leading L axis to skip).
_UNSTACKED = re.compile(r"(embed|unembed|mm_proj|final|enc_final|dec_final)")


def _spec_for(path: str, shape, mesh) -> PartitionSpec:
    stacked = _UNSTACKED.search(path) is None
    for pat, candidates in _RULES:
        if re.search(pat, path):
            if stacked:
                # stacked leaves carry a leading [num_layers] axis
                cands = [(None,) + tuple(c) for c in candidates]
            else:
                cands = list(candidates)
            return choose_spec(shape, cands, mesh)
    return P(*([None] * len(shape)))


def tp_split_dim(path: str) -> int | None:
    """The dim of leaf ``path`` (as stored: a stacked leaf's layer axis
    counts) that tensor parallelism splits along ``model``: where the first
    candidate of the first rule that matches it (as :func:`param_sharding`
    picks the rule) puts ``model``.  That is the leaf's heads, MLP hidden,
    experts, Mamba channels (DI; ``in_proj``'s fused [xin | z] columns,
    2·DI wide) or vocabulary.  None where that candidate has no ``model``
    (the router, norms, ``bo``) or no rule matches."""
    for pat, candidates in _RULES:
        if re.search(pat, path):
            first = tuple(candidates[0])
            if TP not in first:
                return None
            return first.index(TP) + (_UNSTACKED.search(path) is None)
    return None


def names_axis(spec, dim: int, axis: str = TP) -> bool:
    """Whether ``spec`` splits tensor dim ``dim`` over ``axis`` (alone or in
    a combined entry)."""
    entry = tuple(spec)[dim] if dim < len(spec) else None
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def to_placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim.

    A combined entry must name its axes in the mesh's order: DTensor splits a
    dim over several mesh dims in mesh order, which is JAX's order only
    then."""
    from torch.distributed.tensor import Replicate, Shard

    names = _names(mesh)
    dim_of = {}
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        for n in group:
            if n not in names:
                raise ValueError(f"spec {spec} names axis {n!r}, not on the mesh {names}")
            if n in dim_of:
                raise ValueError(f"spec {spec} shards two dims over axis {n!r}")
            dim_of[n] = i
        order = [names.index(n) for n in group]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
    return tuple(Shard(dim_of[n]) if n in dim_of else Replicate() for n in names)


def _ndim(x) -> int:
    return len(getattr(x, "shape", ()))


def _map_named(tree, fn, prefix: str = ""):
    """``fn(name, leaf)`` over a flat or nested dict, a train state (its
    ``OptState`` named tuple included) or a list, keeping the structure.
    Names join keys with ``.``, as the port's flat params do."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(getattr(tree, f), fn, f"{prefix}{f}.")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def param_sharding(params, mesh):
    """NamedSharding tree for a param (or optimizer-state, or train-state)
    tree: a flat dict of the port's leaf names, or any nesting of them."""
    return _map_named(params, lambda name, x: NamedSharding(
        mesh, _spec_for(name, tuple(getattr(x, "shape", ())), mesh)))


def _batch_axes(n: int, mesh):
    """The data-parallel axes (pod, data, in the mesh's order) that divide
    ``n`` rows, greedily, as a tuple; None when none does."""
    sizes = _axes(mesh)
    usable, total = [], 1
    for name in _names(mesh):
        if name in FSDP and n % (total * sizes[name]) == 0:
            usable.append(name)
            total *= sizes[name]
    return tuple(usable) if usable else None


def batch_sharding(batch, mesh):
    """Shard the leading (batch) dim over every data-parallel axis that fits."""
    def leaf(_name, x):
        nd = _ndim(x)
        if nd == 0:
            return NamedSharding(mesh, P())
        axes = _batch_axes(x.shape[0], mesh)
        spec = (axes,) + (None,) * (nd - 1) if axes else (None,) * nd
        return NamedSharding(mesh, P(*spec))

    return _map_named(batch, leaf)


def cache_sharding(cache, mesh, *, kv_heads: int):
    """Decode-cache layout: [L, B, K, S, hd] — batch over data axes, heads
    over 'model' when divisible, else the sequence axis over 'model'
    (flash-decoding partial softmax; DESIGN.md §4).  ``kv_heads`` is taken
    for the JAX signature; the heads are read from each leaf's shape."""
    del kv_heads
    tp = _axes(mesh).get(TP, 1)

    def leaf(name, x):
        nd = _ndim(x)
        if nd == 0:
            return NamedSharding(mesh, P())
        name = name.rsplit(".", 1)[-1]
        if name in ("k", "v", "ck", "cv", "k_scale", "v_scale"):
            b, k, s = x.shape[1], x.shape[2], x.shape[3]
            rest = (None,) * (nd - 4)
            if k % tp == 0:
                spec = P(None, _batch_axes(b, mesh), TP, None, *rest)
            elif s % tp == 0:
                spec = P(None, _batch_axes(b, mesh), None, TP, *rest)
            else:
                spec = P(None, _batch_axes(b, mesh), None, None, *rest)
            return NamedSharding(mesh, spec)
        if name == "ssm_h":
            di = x.shape[2]
            return NamedSharding(mesh, P(None, _batch_axes(x.shape[1], mesh),
                                         TP if di % tp == 0 else None, None))
        if name == "conv":
            di = x.shape[3]
            return NamedSharding(mesh, P(None, _batch_axes(x.shape[1], mesh), None,
                                         TP if di % tp == 0 else None))
        return NamedSharding(mesh, P(*((None,) * nd)))

    return _map_named(cache, leaf)
