from repro_torch.taf import analytics, compile, operators, replay
from repro_torch.taf.plan import Plan, PlanExecutor, PlanResult
from repro_torch.taf.query import HistoricalGraphStore, TemporalQuery
from repro_torch.taf.son import SoN, SoTS, build_son, build_sots

__all__ = [
    "HistoricalGraphStore", "TemporalQuery", "Plan", "PlanExecutor",
    "PlanResult", "analytics", "compile", "operators", "replay", "SoN",
    "SoTS", "build_son", "build_sots",
]
