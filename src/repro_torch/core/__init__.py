"""SOLAR core: the paper's contribution as a composable, pure-Python/numpy
offline scheduler + runtime buffer strategy.

Public API:
  * :func:`repro_torch.core.shuffle.generate_epoch_permutations`
  * :class:`repro_torch.core.planners.Planner` + the strategy planner registry
    (``PLANNERS``) — every strategy compiles to the same Schedule IR
  * :class:`repro_torch.core.scheduler.SolarConfig` / :class:`OfflineScheduler`
  * :class:`repro_torch.core.plan.Schedule` (the schedule IR; ``save``/``load``
    make it an on-disk artifact, ``for_node`` slices per-rank views)
  * :class:`repro_torch.core.planners.PlanCache` (disk memoization by config hash)
  * :class:`repro_torch.core.buffer.BeladyBuffer` / :class:`LRUBuffer`
  * :class:`repro_torch.core.costmodel.PFSCostModel`
"""
from repro_torch.core.buffer import BeladyBuffer, LRUBuffer
from repro_torch.core.costmodel import PFSCostModel
from repro_torch.core.plan import (
    ChunkRead,
    EpochPlan,
    NodeStepPlan,
    PlanArtifactError,
    Schedule,
    StepPlan,
)
from repro_torch.core.planners import PLANNERS, STRATEGIES, PlanCache, Planner, get_planner
from repro_torch.core.scheduler import OfflineScheduler, SolarConfig
from repro_torch.core.shuffle import generate_epoch_permutations

__all__ = [
    "BeladyBuffer",
    "LRUBuffer",
    "PFSCostModel",
    "ChunkRead",
    "EpochPlan",
    "NodeStepPlan",
    "PlanArtifactError",
    "Schedule",
    "StepPlan",
    "Planner",
    "PlanCache",
    "PLANNERS",
    "STRATEGIES",
    "get_planner",
    "OfflineScheduler",
    "SolarConfig",
    "generate_epoch_permutations",
]
