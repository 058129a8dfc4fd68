"""Roofline terms of the dry run's per-device counts, in an H100's constants.

The port of ``repro.launch.roofline``.  ``launch/op_analysis.py`` counts the
per-device program (one rank of the mesh), so the three terms are:

    compute_term_s    = sum over dtypes of device dot FLOPs / that dtype's peak
    memory_term_s     = device_bytes / HBM_BW
    collective_term_s = device collective bytes / the mesh's slowest link

Dot FLOPs go over the peak of their inputs' dtype: the f32 logit GEMMs of a
training step run on the CUDA cores (TF32 off, as ``chip_smoke.py`` sets
it), fifteen times slower than bf16 on the tensor cores, so one peak for all
would make the bound meaningless.  ``step_time_s`` is the perfect-overlap
bound, the largest of the three.

MODEL_FLOPS (the "useful" work) is the analytic 6·N·D for training and
2·N·D for inference (N = active params, D = tokens processed), so
``MODEL_FLOPS / (chips · device_flops)`` exposes remat, duplicated and
padded work.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["PEAK_FLOPS", "HBM_BW", "NET_BW", "NVLINK_BW", "NODE_CARDS", "RooflineReport",
           "analyze", "model_flops", "peak_flops", "link_bw"]

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit: bf16
# and fp16 on the tensor cores, f32 on the CUDA cores (TF32 off).
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
# H100 SXM data sheet: HBM3.
HBM_BW = 3.35e12
# One 400 Gb/s NDR InfiniBand port a card, as in a DGX H100 (eight
# ConnectX-7 ports for eight cards): the rate of a mesh dim whose ranks span
# more than one node.
NET_BW = 50e9
# NVLink 4 (900 GB/s both ways together) in one direction: a mesh dim
# inside one node.
NVLINK_BW = 450e9
#: cards a node (an HGX/DGX H100 board)
NODE_CARDS = 8


def peak_flops(dtype: str) -> float:
    """The dot peak of a dtype name; other dtypes (f64, integers) take the
    f32 CUDA-core peak."""
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS["float32"])


def link_bw(mesh_shape: tuple, dim: int) -> float:
    """The per-card rate of mesh dim ``dim`` of a row-major mesh over
    consecutive ranks, ``NODE_CARDS`` a node: NVLink where each group of the
    dim lies in one node (its block of ``size * stride`` consecutive ranks
    tiles the nodes), the network where it spans nodes."""
    size, stride = mesh_shape[dim], math.prod(mesh_shape[dim + 1:])
    return NVLINK_BW if size == 1 or NODE_CARDS % (size * stride) == 0 else NET_BW


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n = cfg.num_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step.
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    device_flops_by_dtype: dict
    device_bytes: float
    device_collective_bytes: float
    model_flops: float
    collective_parse_ok: bool
    collective_bw: float = NET_BW

    @property
    def device_flops(self) -> float:
        return sum(self.device_flops_by_dtype.values())

    @property
    def compute_term_s(self) -> float:
        return sum(f / peak_flops(d) for d, f in self.device_flops_by_dtype.items())

    @property
    def memory_term_s(self) -> float:
        return self.device_bytes / HBM_BW

    @property
    def collective_term_s(self) -> float:
        return self.device_collective_bytes / self.collective_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_term_s,
            "memory": self.memory_term_s,
            "collective": self.collective_term_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_term_s, self.memory_term_s, self.collective_term_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.chips * self.device_flops
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization (at the bf16 peak) at the roofline-bound
        step time."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS["bfloat16"] * t)

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_term_s,
            "memory_s": self.memory_term_s,
            "collective_s": self.collective_term_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "device_flops": self.device_flops,
            "useful_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu,
            "coll_parse_ok": self.collective_parse_ok,
        }


def analyze(arch, shape, mesh_name, chips, stats, mflops, *,
            collective_bw: float = NET_BW) -> RooflineReport:
    """``stats`` comes from ``op_analysis.program_stats`` (or the dry run's
    scaling of it): dot FLOPs by dtype, HBM traffic and collective result
    bytes, all per device.  ``collective_bw`` is the slowest link of the
    mesh's dims (``link_bw``)."""
    coll = stats["collectives"]
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        device_flops_by_dtype=dict(stats["dot_flops_by_dtype"]),
        device_bytes=float(stats["traffic_bytes"]),
        device_collective_bytes=float(coll["total"]),
        model_flops=mflops,
        collective_parse_ok=bool(coll["ok"]),
        collective_bw=collective_bw,
    )
