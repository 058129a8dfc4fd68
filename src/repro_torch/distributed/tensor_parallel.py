"""Tensor parallelism along the mesh's ``model`` axis: each model rank
computes its own attention heads, MLP hidden units, Mamba channels and
vocabulary columns, as the JAX package's layout does.

The JAX package pins q/k/v to heads over ``model`` and the SwiGLU hidden to
hidden over ``model`` (``constrain``), so XLA's partitioner computes only a
rank's heads, channels and hidden units and all-reduces the row-parallel
outputs.  The port's model code runs on plain tensors, so the split is
written out, as Megatron-LM pairs it:

* column-parallel leaves (``wq``/``wk``/``wv`` and their biases, ``wi_gate``
  and ``wi_up``, and the Mamba leaves on DI: ``in_proj``, ``conv_w``,
  ``conv_b``, ``dt_proj``, ``dt_bias``, ``a_log``, ``d_skip``) take the
  replicated input through :func:`copy_in` (Megatron's *f*: identity
  forward, all-reduce of the gradient) and give the rank's heads, hidden
  units or channels;
* row-parallel leaves (``wo``, ``wo_mlp``, ``x_proj``, ``out_proj``) give a
  partial sum that :func:`reduce_out` all-reduces (*g*: all-reduce forward,
  identity backward).  ``x_proj``'s output (dt, B and C) feeds every
  channel, so it goes through *g* and then *f*;
* the vocabulary: the embedding is a masked lookup of the local rows and an
  all-reduce (:func:`embed`), the logits are the local vocabulary's, the
  chunked cross-entropy takes the row max, Σexp and the target logit over
  ``model`` with all-reduces (:func:`ce_sum`), and serving gathers the
  logits whole (:func:`gather_vocab`).

The residual stream, the norms (K1 on the whole ``d``) and the loss stay
replicated along ``model``; in the forward every collective along ``model``
is an all-reduce (serving's logit gather aside).

:func:`split_plan` reads which parts split from the specs ``param_sharding``
chose: attention where ``wq`` is split over ``model`` on its heads and the
kv heads either divide the axis or are repeated to it (``CacheSpec``'s
repeat case: a rank computes the one kv head its block of query heads
reads), the MLP where ``wi_gate`` (the moe family: the shared expert's
``ws_gate``) is split on its hidden, the routed experts where ``we_gate``
is split on its experts, the Mamba mixer where ``conv_w`` is split on DI,
the vocabulary (the embedding's rows and the logits' columns) where the
output weight (``embed`` when tied, else ``unembed``) is split on it.  A
part that does not split is computed whole on every model rank from leaves
gathered along ``model``, as before.  Every family splits.  The
encoder-decoder's attention is its encoder's self-attention and its
decoder's self- and cross-attention (each split where ``enc_layers.attn.wq``
is), its MLP the GELU MLPs of both stacks (``wi``, ``bi`` and ``wo``; ``bo``
is added once, after the all-reduce), its vocabulary the tied ``embed``.

The decode cache of an attention that does not split, whose kv heads do not
divide the axis, holds the rank's block of the cache's slots instead
(:func:`cache_block`), as ``cache_sharding`` puts the sequence over
``model`` where the heads do not divide it: decode attention takes the
partial softmax over the rank's slots and all-reduces its max, its sum and
its product with V (``layers.decode_attention``).  A plan exists wherever
the model axis has more than one rank, even with no part split, so such a
rank still has the model group.

The moe family routes whole on every rank (the router is no member: its
spec has no ``model``) and computes only the rank's experts' capacity
slots, as GSPMD does with the JAX layout's experts over ``model``: the
expert region's input and the gates go through *f*, the routed and the
shared expert's partial sums through one *g* (``layers.moe_layer``).  The
vlm family's decoder splits as dense; ``mm_proj`` is no member, so it is
gathered whole (its spec puts ``model`` on the output ``d``, which the
replicated residual stream must not split).

A plan's ``leaves`` say which block of its split dim the rank uses of each
leaf of a split part.  A leaf stored split on that dim (``LOCAL``) reaches
the model as its local shard, gathered over the data axes only.  Any other
(``SLICE``: ``wk`` and ``wv`` in the repeat case; ``HALVES``: ``in_proj``,
whose JAX layout splits its fused [xin | z] columns so that model rank 0
stores all of xin and rank 1 all of z) is gathered whole and sliced, and
its gradient is summed over ``model`` (``distributed/fsdp.py``).  Serving
on whole params takes the same blocks (:func:`local_view`).

The model code finds the plan in the params it is handed, under
:data:`KEY`; params without one run today's path.  The view that carries it
(``fsdp.gathered``'s, :func:`local_view`'s) is for the model alone, and
each code that walks such a dict passes the plan on as it is:
``lm.nested_params`` (at the top, under its dot-free name) and
``ServeEngine``'s move to its device.  The train step, the optimizer,
checkpoints and :func:`split_plan` take params without it.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KEY", "LOCAL", "SLICE", "HALVES", "SplitPlan", "split_plan", "block",
           "cache_block", "take_block", "local_view", "plan_of", "all_reduce", "copy_in",
           "reduce_out", "embed", "ce_sum", "gather_vocab"]

#: where the model's params carry the plan
KEY = "tensor_parallel"
LOCAL, SLICE, HALVES = "local", "slice", "halves"
FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")

_ATTN = ("wq", "wk", "wv", "bq", "bk", "bv", "wo")
_MLP = ("wi_gate", "wi_up", "wo_mlp")
_SHARED = ("ws_gate", "ws_up", "ws_down")
_EXPERTS = ("we_gate", "we_up", "we_down")
_MAMBA = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "a_log",
          "d_skip", "out_proj")
#: the encoder-decoder's attention and MLP stacks, and their leaves
_ENCDEC_ATTN = tuple(f"{stack}.{n}" for stack in ("enc_layers.attn", "dec_layers.self",
                                                  "dec_layers.cross")
                     for n in ("wq", "wk", "wv", "wo"))
_ENCDEC_MLP = tuple(f"{stack}.{n}" for stack in ("enc_layers.mlp", "dec_layers.mlp")
                    for n in ("wi", "bi", "wo"))


def block(n: int, size: int, rank: int) -> tuple[int, int]:
    """(start, length) of model rank ``rank``'s block of a dim of ``n``:
    the ``rank``-th of ``size`` equal blocks, or, where ``n`` heads are
    repeated to ``size`` (``size`` a multiple of ``n``), the one head the
    rank's query heads read."""
    if n % size == 0:
        return rank * (n // size), n // size
    if size % n == 0:
        return rank * n // size, 1
    raise ValueError(f"a dim of {n} splits over {size} model ranks neither way")


@dataclasses.dataclass(frozen=True, eq=False)
class SplitPlan:
    """Which parts of the model split along ``model`` on this rank, and how
    (module docstring).  ``leaves`` maps a leaf name to (its split dim as
    stored, ``LOCAL`` | ``SLICE`` | ``HALVES``)."""

    group: object
    size: int
    rank: int
    attention: bool
    mlp: bool
    mamba: bool
    vocab: bool
    experts: bool
    leaves: dict

    def block(self, n: int) -> tuple[int, int]:
        return block(n, self.size, self.rank)


def split_plan(cfg, params: dict, mesh) -> SplitPlan | None:
    """The plan of ``cfg``'s model on ``mesh`` for flat ``params`` (tensors
    or DTensors: only names and global shapes are read); None where no
    ``model`` axis has more than one rank (or for a family other than
    ``FAMILIES``); the interleaved family raises on a ``model`` axis of
    more than one rank.  Where no part splits the plan still carries the model
    group, for the cache's sequence split (:func:`cache_block`)."""
    from repro_torch.distributed.sharding import names_axis, param_sharding, tp_split_dim

    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    family = getattr(cfg, "family", None)
    size = mesh.size(names.index("model"))
    if size > 1 and family == "interleaved":
        raise NotImplementedError(
            f"the interleaved family ({cfg.name}) has no split plan: its per-kind layer "
            f"stacks do not split along model yet")
    if family not in FAMILIES or size == 1:
        return None
    specs = {k: s.spec for k, s in param_sharding(params, mesh).items()}

    def stored_split(name: str) -> bool:
        dim = tp_split_dim(name)
        return name in specs and dim is not None and names_axis(specs[name], dim)

    fam, k = cfg.family, cfg.num_kv_heads
    out_w = "embed" if cfg.tie_embeddings else "unembed"
    if fam == "encdec":
        attn, mlp = _ENCDEC_ATTN, _ENCDEC_MLP
    else:
        attn = tuple(f"layers.{n}" for n in _ATTN)
        mlp = tuple(f"layers.{n}" for n in (_SHARED if fam == "moe" else _MLP))
    parts = {
        "attention": fam != "ssm" and stored_split(attn[0])
        and (k % size == 0 or size % k == 0),
        "mlp": stored_split(mlp[0]),
        "mamba": fam in ("ssm", "hybrid") and stored_split("layers.ssm.conv_w"),
        "vocab": stored_split(out_w),
        "experts": stored_split("layers.we_gate"),
    }
    members = {"attention": attn, "mlp": mlp,
               "mamba": [f"layers.ssm.{n}" for n in _MAMBA],
               "vocab": ["embed", "unembed"],
               "experts": [f"layers.{n}" for n in _EXPERTS]}
    leaves = {}
    for part, split in parts.items():
        for name in members[part] if split else ():
            if name in specs:
                leaves[name] = (tp_split_dim(name), LOCAL if stored_split(name) else SLICE)
    if parts["mamba"]:
        leaves["layers.ssm.in_proj"] = (tp_split_dim("layers.ssm.in_proj"), HALVES)
    return SplitPlan(mesh.get_group("model"), size, mesh.get_local_rank("model"),
                     leaves=leaves, **parts)


def cache_block(plan: SplitPlan | None, spec) -> tuple[int, int] | None:
    """(start, length) of the decode cache's slots a model rank holds in a
    decoder-only model (``models/lm.py``; the encoder-decoder keeps a cache
    of heads that do not split whole), for a ``CacheSpec`` built for the
    plan's model axis: its equal block of the ``cache_len`` slots (a ring's
    included) where attention does not split, the kv heads do not divide
    the axis and the slots do; None where the cache stays whole (no plan,
    split heads, heads that divide the axis, or slots that do not), as
    ``cache_sharding``'s last branch keeps it."""
    if plan is None or plan.attention or not spec.kv_heads:
        return None
    if spec.kv_heads % plan.size == 0 or spec.cache_len % plan.size:
        return None
    n = spec.cache_len // plan.size
    return plan.rank * n, n


def take_block(x: torch.Tensor, dim: int, mode: str, plan: SplitPlan) -> torch.Tensor:
    """The rank's block of ``x`` along ``dim``: one block, or (``HALVES``)
    its block of each half, concatenated."""
    n = x.shape[dim]
    if mode == HALVES:
        start, length = plan.block(n // 2)
        return torch.cat([x.narrow(dim, start, length),
                          x.narrow(dim, n // 2 + start, length)], dim)
    start, length = plan.block(n)
    return x.narrow(dim, start, length)


def local_view(params: dict, plan: SplitPlan | None) -> dict:
    """Serving's view of whole ``params`` (flat, or nested as ``init_lm``
    gives them) on a model rank: each leaf of a split part cut to the
    rank's block (a copy, so the whole leaf can be freed), and the plan
    under :data:`KEY`.  ``params`` as they are without a plan."""
    from repro_torch.distributed.sharding import _map_named

    if plan is None:
        return params

    def leaf(name, x):
        how = plan.leaves.get(name)
        return x if how is None else take_block(x, *how, plan).contiguous()

    out = _map_named(params, leaf)
    out[KEY] = plan
    return out


def plan_of(params: dict) -> SplitPlan | None:
    """The plan the model's ``params`` carry (None: nothing splits)."""
    return params.get(KEY)


def all_reduce(x: torch.Tensor, plan: SplitPlan, op=None) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over the model ranks, in a new tensor."""
    import torch.distributed as dist

    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=plan.group)
    return out


class _CopyIn(torch.autograd.Function):
    """Megatron's *f*: identity forward, the gradient all-reduced."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.plan), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's *g*: the partial sums all-reduced forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, plan):
        return all_reduce(x, plan)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_in(x: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """The replicated input of a column-parallel region."""
    return _CopyIn.apply(x, plan)


def reduce_out(x: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """The whole output of a row-parallel region from each rank's part."""
    return _ReduceOut.apply(x, plan)


def embed(weight: torch.Tensor, tokens: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """Rows of the embedding for ``tokens`` from the local rows ``weight
    [V / size, D]``: each rank looks up the tokens in its range (the others
    read 0) and the parts are all-reduced, exactly (one rank adds a
    nonzero)."""
    n = weight.shape[0]
    idx = tokens - plan.rank * n
    inside = (idx >= 0) & (idx < n)
    rows = weight[idx.clamp(0, n - 1)].masked_fill(~inside[..., None], 0)
    return reduce_out(rows, plan)


def ce_sum(h: torch.Tensor, w32: torch.Tensor, labels, valid, plan: SplitPlan):
    """Σ weighted NLL of one chunk over the local vocabulary ``w32 [D, V /
    size]`` (``h`` already through :func:`copy_in`): the row max (a
    constant of the logsumexp, taken without a gradient), Σexp and the
    target's logit each all-reduced over the model ranks."""
    import torch.distributed as dist

    logits = torch.einsum("bsd,dv->bsv", h.float(), w32)
    n = logits.shape[-1]
    m = all_reduce(logits.detach().amax(dim=-1), plan, dist.ReduceOp.MAX)
    se = reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1), plan)
    idx = labels.clamp_min(0).long() - plan.rank * n
    inside = (idx >= 0) & (idx < n)
    tgt = torch.gather(logits, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    tgt = reduce_out(tgt.masked_fill(~inside, 0), plan)
    return ((m + torch.log(se) - tgt) * valid).sum()


def gather_vocab(logits: torch.Tensor, plan: SplitPlan) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's ``[..., V / size]``
    (serving: no gradient)."""
    import torch.distributed as dist

    src = logits.movedim(-1, 0).contiguous()
    out = src.new_empty((plan.size * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=plan.group)
    return out.movedim(0, -1).contiguous()
