"""Per-device program statistics by counting the ops a program dispatches.

The counterpart of the JAX package's ``repro.launch.hlo_analysis``, which
walks the compiled HLO text of a partitioned program.  The port's programs
run eagerly, so there is no HLO: :func:`program_stats` runs the program
under a ``TorchDispatchMode`` and counts every aten and c10d op it
dispatches, on meta tensors (the dry run: shapes only, nothing computed) or
on the card's real ones.  It returns JAX's keys and adds three:

* ``dot_flops`` — ``2·M·N·K`` of every mm/bmm/addmm/baddbmm/convolution
  (``torch.utils.flop_counter``'s formulas), plus the score and value
  products the flash-attention kernel records (``kernels/work.py``);
  ``dot_flops_by_dtype`` splits them by the inputs' dtype.
* ``traffic_bytes`` — the bytes each op reads and writes: in eager mode every
  op is its own fusion boundary, so each op that is not a view counts its
  inputs plus its outputs.  As in JAX's rule (``hlo_analysis.py:260-272``)
  a gather (``index``, ``index_select``, ``gather``, ``embedding``) counts
  twice its result, and a scatter into a buffer (``index_put_``,
  ``scatter``, ``index_add_``...) twice its operands less the buffer; a copy
  reads its source and writes its destination; allocation alone (``empty``)
  moves nothing.  A broadcast input counts its distinct elements.  The
  hand-written kernels add the bytes they record (tag ``kernels``).
  ``traffic_by_tag`` splits the bytes by the model function the op ran in:
  ``attn_interior`` (the plain attention paths), ``ssm_interior`` (the plain
  scan), ``ce`` (the chunked cross-entropy), ``kernels`` and ``other``.
  The tags follow the Python frames, so a backward op (run by autograd's
  engine, not inside the forward's function) counts under ``other``; a
  rematerialised forward counts under its function's tag.
* ``collectives`` — the result bytes of each c10d collective by
  ``COLLECTIVE_KINDS``, with ``total``.  Eager code runs every layer and
  microbatch, so nothing is weighted by a trip count and ``flat_total`` is
  ``total``; ``ok`` is false where a c10d op of no known kind ran.
* ``kernels`` — each hand-written kernel's recorded work (``calls``,
  ``dot_flops``, ``f32_ops``, ``exps``, ``bytes``), recorded the same on the
  card and on meta tensors.
* ``peak_bytes`` — the peak of the bytes of live storages on the program's
  device, the arguments' included (a view shares its base's storage, so
  storages, not tensors, are counted); ``argument_bytes``,
  ``output_bytes`` and ``alias_bytes`` (outputs that are arguments'
  storages) beside it.

The program's device is the device of its first tensor argument; ops whose
tensors all lie elsewhere (the host's RNG state, say) are not counted.  Ops
run under ``torch.inference_mode`` bypass the dispatch mode and are not
counted either: count a serving program under ``torch.no_grad``, as the
dry run's are.
"""
from __future__ import annotations

import sys
import weakref
from collections import defaultdict

import torch

from repro_torch.kernels import work

__all__ = ["COLLECTIVE_KINDS", "program_stats", "tensors_of", "storage_bytes"]

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: c10d ops by kind; the byte count is the op's result, its first argument.
_C10D = {
    "_allgather_base_": "all-gather", "_reduce_scatter_base_": "reduce-scatter",
    "allreduce_": "all-reduce", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_ALLOC = {"empty", "empty_strided", "new_empty", "new_empty_strided", "empty_like"}
_FILL = {"fill_", "zero_"}
_GATHER = {"index", "index_select", "gather", "embedding", "take_along_dim"}
_SCATTER = {"index_put_", "index_put", "scatter", "scatter_", "scatter_add",
            "scatter_add_", "index_add", "index_add_", "index_copy", "index_copy_",
            "_index_put_impl_"}
#: the model functions whose ops carry a tag (innermost frame wins)
_TAGS = {
    "attention_ref": "attn_interior", "attention_blockwise": "attn_interior",
    "attention_local": "attn_interior", "decode_attention": "attn_interior",
    "_selective_scan": "ssm_interior", "selective_scan_ref": "ssm_interior",
    "_prefix_scan": "ssm_interior",
    "_chunked_ce": "ce", "_ce_chunk": "ce",
}


def tensors_of(tree, out=None) -> list:
    """The plain tensors of a tree (dicts, lists, tuples, named tuples); a
    DTensor gives its local shard.  (No closure: a recursive one would hold
    the list, and every tensor the counter sees, in a reference cycle.)"""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        local = getattr(tree, "_local_tensor", None)
        out.append(tree if local is None else local)
    elif isinstance(tree, dict):
        for v in tree.values():
            tensors_of(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            tensors_of(v, out)
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(tree, device_type: str) -> int:
    """Bytes of the distinct storages of a tree's tensors on a device type."""
    seen = {}
    for t in tensors_of(tree):
        if t.device.type == device_type:
            seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its distinct elements (a broadcast dim of
    stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tag() -> str:
    frame = sys._getframe(2)
    while frame is not None:
        tag = _TAGS.get(frame.f_code.co_name)
        if tag is not None:
            return tag
        frame = frame.f_back
    return "other"


class _Counter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type
        self.ops = 0
        self.flops = defaultdict(float)
        self.traffic = defaultdict(float)
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}
        self.coll_ok = True
        self.kernels = {}
        self.live = {}
        self.now = 0
        self.peak = 0

    # -- storages -------------------------------------------------------------

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def track(self, t: torch.Tensor) -> None:
        if t.device.type != self.device_type:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    # -- kernels --------------------------------------------------------------

    def kernel(self, name: str, w: work.Work, dtype) -> None:
        rec = self.kernels.setdefault(name, {"calls": 0, **{f: 0 for f in work.Work._fields}})
        rec["calls"] += 1
        for f in work.Work._fields:
            rec[f] += getattr(w, f)
        if w.dot_flops:
            self.flops[str(dtype).removeprefix("torch.")] += w.dot_flops
        self.traffic["kernels"] += w.bytes

    # -- ops ------------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = tensors_of((args, kwargs)), tensors_of(out)
        if not any(t.device.type == self.device_type for t in ins + outs):
            return out
        self.ops += 1
        for t in outs:
            self.track(t)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            self._collective(name, args)
            return out
        self._flops(func, args, kwargs, out, ins)
        self._traffic(func, name, ins, outs)
        return out

    def _collective(self, name, args):
        kind = _C10D.get(name)
        if kind is None:
            self.coll_ok = False
            return
        # the result is the first argument (in place for an all-reduce); the
        # op reads its operand and writes its result
        result = sum(_nbytes(t) for t in tensors_of(args[0]))
        operand = sum(_nbytes(t) for t in tensors_of(args[1:])) or result
        self.coll[kind] += result
        self.traffic[_tag()] += result + operand

    def _flops(self, func, args, kwargs, out, ins):
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is None:
            return
        local = torch.utils._pytree.tree_map_only(
            torch.Tensor, lambda x: getattr(x, "_local_tensor", x), (args, kwargs, out))
        flops = formula(*local[0], **local[1], out_val=local[2])
        self.flops[str(ins[0].dtype).removeprefix("torch.")] += flops

    def _traffic(self, func, name, ins, outs):
        if name in _ALLOC or func.is_view or name in ("detach", "alias", "_unsafe_view",
                                                       "lift_fresh"):
            return
        if name in _GATHER:
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        elif name in _SCATTER:
            sizes = [_nbytes(t) for t in ins]
            nbytes = 2 * (sum(sizes) - max(sizes))
        elif name in _FILL:
            nbytes = sum(_nbytes(t) for t in outs)
        elif name == "copy_":  # reads the source, writes the destination
            nbytes = sum(_nbytes(t) for t in ins[1:]) + sum(_nbytes(t) for t in outs)
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.traffic[_tag()] += nbytes


def program_stats(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under the counter and return its
    per-device statistics (module docstring).  The result of ``fn`` is
    dropped once its outputs are measured."""
    first = next(iter(tensors_of((args, kwargs))), None)
    device_type = first.device.type if first is not None else "cpu"
    counter = _Counter(device_type)
    for t in tensors_of((args, kwargs)):
        counter.track(t)
    argument = counter.now
    arg_keys = set(counter.live)
    with work.recording(counter.kernel), counter:
        result = fn(*args, **kwargs)
    out_tensors = [t for t in tensors_of(result) if t.device.type == device_type]
    out_storages = {_key(t): t.untyped_storage().nbytes() for t in out_tensors}
    alias = sum(n for k, n in out_storages.items() if k in arg_keys)
    del result, out_tensors
    coll = dict(counter.coll)
    coll["total"] = sum(counter.coll.values())
    coll["flat_total"] = coll["total"]
    coll["ok"] = counter.coll_ok
    return {
        "ops": counter.ops,
        "dot_flops": sum(counter.flops.values()),
        "dot_flops_by_dtype": dict(counter.flops),
        "traffic_bytes": sum(counter.traffic.values()),
        "traffic_by_tag": dict(counter.traffic),
        "collectives": coll,
        "kernels": counter.kernels,
        "peak_bytes": counter.peak,
        "argument_bytes": argument,
        "output_bytes": sum(out_storages.values()),
        "alias_bytes": alias,
    }
