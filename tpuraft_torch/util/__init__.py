"""L1 runtime utilities (reference: core:util/ — SURVEY.md §3.1)."""

from tpuraft_torch.util.timer import RepeatedTimer
from tpuraft_torch.util.metrics import MetricRegistry
from tpuraft_torch.util import describer

__all__ = ["RepeatedTimer", "MetricRegistry", "describer"]
