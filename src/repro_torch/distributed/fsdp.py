"""Fully sharded params for the train step on a ``DeviceMesh``.

Each leaf of the train state lives as a DTensor in ``param_sharding``'s
layout (:func:`distribute`).  A step hands the model a *gathered view* of
its params (:func:`gathered`): a leaf under ``layers``, ``enc_layers`` or
``dec_layers`` is gathered one layer at a time, when the model's layer loop
indexes it (``lm._layer``'s ``leaf[i]``), and any other leaf is gathered
whole once a microbatch.  The model code therefore sees plain tensors and
runs the hand-written kernels on them unchanged; the full weights alive at
once are one layer's (a remat recompute gathers again) beside the shards.

The DTensors only record the layout.  A gather, its backward and the step's
sums run one collective per mesh dim on that dim's process group
(``mesh.get_group(d)``), and a mesh dim of one rank runs none: on a
one-rank mesh the view is the shards themselves and the sharded step is the
plain step.  The rule engine only shards a dim over axes that divide it, so
every shard along a dim has the same size.

The gradient of a gather is not a slice, as DTensor's own backward of a
gather takes it: that assumes every rank saw the same upstream gradient.
Here the ranks of the data-parallel mesh dims (``reduce_dims``: the pod and
data axes the batch is split over, :func:`batch_mesh_dims`) computed
gradients of their own rows, so :class:`_Gather`'s backward sums them (a
reduce-scatter where the leaf is sharded over the dim, an all-reduce where
it is replicated) and slices along the other dims (the ``model`` ranks saw
the same rows).

Along ``model`` the view follows the split plan
(``distributed/tensor_parallel.py``): a leaf of a part that splits reaches
the model as its ``model`` shard (gathered over the data axes only, its
gradient reduced over them only), or, where its layout does not put
``model`` on the split dim (``in_proj``, repeated kv heads), gathered whole
and cut to the rank's block, its gradient then summed over ``model`` too:
each model rank computed only its own block's.  Every other leaf is
gathered along ``model`` like the data axes and computed whole on each
model rank; its gradient is the same there and is not reduced along
``model``.  So the moe family's experts reach each rank as its block of
the experts, their gradients staying on their rank, and the router, whose
spec has no ``model``, is whole on every rank with its gradient reduced
over the data axes only, like the norms'.

SOLAR's nodes are the data axis: data rank ``r`` trains the ``r``-th block
of ``batch_mesh_dims``' rows of the global batch (:func:`local_rows`), which
``StepBatch.to_global`` lays out node by node.
"""
from __future__ import annotations

import torch

__all__ = ["STACKED", "LayerGather", "check_mesh", "distribute", "local",
           "wrap_like", "batch_mesh_dims", "local_rows", "all_reduce", "gathered",
           "global_norm", "whole"]

#: Subtrees whose leaves carry a leading layer axis the model indexes per layer.
STACKED = ("layers.", "enc_layers.", "dec_layers.")


def check_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a ``DeviceMesh`` over a live process group:
    a sharded step never runs on a mesh it cannot communicate over."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a sharded step needs a torch DeviceMesh, not {type(mesh).__name__}")
    if not dist.is_initialized():
        raise RuntimeError("the mesh has no process group (init_process_group first)")
    if mesh.mesh_dim_names is None:
        raise ValueError("the mesh needs axis names (mesh_dim_names)")


def distribute(t: torch.Tensor, sharding):
    """``t`` as a DTensor in ``sharding``'s layout (a ``NamedSharding``;
    every rank passes the same values, rank 0's are kept)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, sharding.mesh, sharding.placements)


def local(x):
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def wrap_like(local_tree: dict, like_tree: dict) -> dict:
    """Local shards back into DTensors in the layouts and global shapes of
    ``like_tree``'s DTensors."""
    from torch.distributed.tensor import DTensor

    return {k: DTensor.from_local(t, like_tree[k].device_mesh, like_tree[k].placements,
                                  run_check=False, shape=like_tree[k].shape,
                                  stride=like_tree[k].stride())
            for k, t in local_tree.items()}


def batch_mesh_dims(rows: int, mesh) -> tuple:
    """The mesh dims the batch's leading dim is split over: the pod and data
    axes that divide ``rows``, as ``batch_sharding`` picks them."""
    from repro_torch.distributed.sharding import _batch_axes

    names = tuple(mesh.mesh_dim_names)
    return tuple(names.index(n) for n in (_batch_axes(rows, mesh) or ()))


def local_rows(batch: dict, mesh, reduce_dims: tuple) -> dict:
    """This rank's contiguous block of each leaf's rows: the blocks go
    pod-major over ``reduce_dims``, as a batch-sharded DTensor's do."""
    index, parts = 0, 1
    for d in reduce_dims:
        index = index * mesh.size(d) + mesh.get_local_rank(d)
        parts *= mesh.size(d)
    out = {}
    for k, x in batch.items():
        n = x.shape[0] // parts
        out[k] = x[index * n:(index + 1) * n]
    return out


def all_reduce(t: torch.Tensor, mesh, reduce_dims: tuple) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``reduce_dims`` (``t`` itself when
    none has more than one rank)."""
    import torch.distributed as dist

    live = [d for d in reduce_dims if mesh.size(d) > 1]
    if not live:
        return t
    t = t.clone()
    for d in live:
        dist.all_reduce(t, group=mesh.get_group(d))
    return t


def _gather(shard: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The whole tensor from every rank's shard: an all-gather along each
    sharded dim, the innermost mesh dim first (a dim split over two mesh
    dims is split over the outer one first, as DTensor lays it out)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    x = shard
    for d in reversed(range(mesh.ndim)):
        n, p = mesh.size(d), placements[d]
        if n == 1 or not isinstance(p, Shard):
            continue
        src = x.movedim(p.dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(d))
        x = out.movedim(0, p.dim)
    return x.contiguous()


def whole(x) -> torch.Tensor:
    """The whole tensor of a DTensor, gathered with this module's
    collectives (DTensor's ``full_tensor`` runs functional collectives, which
    crash a gloo group over CUDA tensors in torch 2.11); a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return _gather(x.to_local(), x.device_mesh, tuple(x.placements))


def _reduce_to_shard(grad: torch.Tensor, mesh, placements, reduce_dims) -> torch.Tensor:
    """The shard's gradient from the whole tensor's: summed over the ranks
    of ``reduce_dims`` (a reduce-scatter where the leaf is sharded over the
    dim, an all-reduce where it is replicated), sliced along the other
    sharded dims, the outermost mesh dim first."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    x = grad
    for d in range(mesh.ndim):
        n, p = mesh.size(d), placements[d]
        if n == 1:
            continue
        if isinstance(p, Shard):
            if d in reduce_dims:
                src = x.movedim(p.dim, 0).contiguous()
                out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
                dist.reduce_scatter_tensor(out, src, group=mesh.get_group(d))
                x = out.movedim(0, p.dim)
            else:
                x = x.chunk(n, dim=p.dim)[mesh.get_local_rank(d)]
        elif d in reduce_dims:
            x = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(x, group=mesh.get_group(d))
    return x.contiguous()


class _Gather(torch.autograd.Function):
    """local shard -> the whole tensor; backward: the upstream gradient
    summed over ``reduce_dims``, then laid out as the shard."""

    @staticmethod
    def forward(ctx, shard, mesh, placements, reduce_dims):
        ctx.mesh, ctx.placements, ctx.reduce_dims = mesh, placements, reduce_dims
        return _gather(shard.detach(), mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_to_shard(grad, ctx.mesh, ctx.placements, ctx.reduce_dims), None, \
            None, None


def _drop_leading(placements) -> tuple:
    """Placements of one layer of a stacked leaf: ``Shard(d)`` -> ``Shard(d-1)``."""
    from torch.distributed.tensor import Shard

    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim == 0:
                raise ValueError("a stacked leaf is sharded over its layer axis")
            p = Shard(p.dim - 1)
        out.append(p)
    return tuple(out)


class LayerGather:
    """A stacked leaf's local shard: ``[i]`` gathers layer ``i`` as the
    model sees it (whole, or its ``model`` block: :func:`gathered`)."""

    def __init__(self, shard: torch.Tensor, like, reduce_dims: tuple, placements=None,
                 take=None, plan=None):
        self.shard, self.mesh, self.reduce_dims = shard, like.device_mesh, reduce_dims
        self.placements = _drop_leading(like.placements if placements is None
                                        else placements)
        self.take, self.plan = take, plan

    def __getitem__(self, i: int) -> torch.Tensor:
        x = _Gather.apply(self.shard[i], self.mesh, self.placements, self.reduce_dims)
        if self.take is None:
            return x
        from repro_torch.distributed.tensor_parallel import take_block

        dim, mode = self.take
        return take_block(x, dim - 1, mode, self.plan)


def _per_layer(name: str, like) -> bool:
    from torch.distributed.tensor import Shard

    return (name.startswith(STACKED) and like.ndim > 0
            and not any(isinstance(p, Shard) and p.dim == 0 for p in like.placements))


def gathered(shards: dict, params: dict, mesh, reduce_dims: tuple, plan=None) -> dict:
    """The model's view of the params: ``shards`` are the local shards
    (requiring grad) of the DTensors ``params`` on ``mesh``; stacked leaves
    become :class:`LayerGather`, the others are gathered now.  With a split
    ``plan`` (``tensor_parallel.split_plan``) the leaves of its parts come
    as their ``model`` blocks and the view carries the plan.  On a one-rank
    mesh the shards are the whole leaves."""
    from torch.distributed.tensor import Replicate

    from repro_torch.distributed import tensor_parallel as tp

    if mesh.size() == 1:
        return shards
    md = tuple(mesh.mesh_dim_names).index("model") if plan is not None else None
    out = {}
    for k, shard in shards.items():
        p = params[k]
        placements, dims, take = tuple(p.placements), tuple(reduce_dims), None
        how = plan.leaves.get(k) if plan is not None else None
        if how is not None and how[1] == tp.LOCAL:
            # the model shard is the block: gathered over the data axes only
            placements = placements[:md] + (Replicate(),) + placements[md + 1:]
        elif how is not None:
            dims, take = dims + (md,), how
        if _per_layer(k, p):
            out[k] = LayerGather(shard, p, dims, placements, take, plan)
        else:
            x = _Gather.apply(shard, mesh, placements, dims)
            out[k] = x if take is None else tp.take_block(x, *take, plan)
    if plan is not None:
        out[tp.KEY] = plan
    return out


def global_norm(grads: dict, params: dict, mesh) -> torch.Tensor:
    """``optim.adamw.global_norm`` of the whole gradients from their local
    shards ``grads`` (laid out as the DTensors ``params``): each leaf's sum
    of squares over its shard, summed over the ranks of the mesh dims it is
    sharded on (one all-reduce of every leaf's sum a mesh dim; a leaf
    replicated over the dim counts its rank 0's), then summed in leaf order.
    A split step's gradients keep the params' layout (a split leaf's shard
    is its ``model`` block, a replicated leaf's gradient the same on every
    model rank), so this holds for it unchanged."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    sums = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()])
    for d in range(mesh.ndim):
        if mesh.size(d) == 1:
            continue
        if mesh.get_local_rank(d) != 0:
            sharded = [isinstance(params[k].placements[d], Shard) for k in grads]
            sums = sums * torch.tensor(sharded, dtype=sums.dtype, device=sums.device)
        dist.all_reduce(sums, group=mesh.get_group(d))
    return torch.sqrt(sum(sums.unbind()))
