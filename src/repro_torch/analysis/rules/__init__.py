"""Rule registry for the layer-1/3 AST lint engine (stdlib-only)."""

from typing import List

from ..lint import Rule
from .capture_sync import CaptureSyncRule
from .estimator_pull import EstimatorPullRule
from .fallbacks import MissingFallbackRule
from .fixed_point import FixedPointRule
from .int32_packing import Int32PackingRule
from .locks import LockDisciplineRule
from .nondeterminism import NondeterminismRule
from .stats_width import StatsWidthRule


def all_rules() -> List[Rule]:
    return [
        CaptureSyncRule(),
        EstimatorPullRule(),
        FixedPointRule(),
        NondeterminismRule(),
        Int32PackingRule(),
        StatsWidthRule(),
        MissingFallbackRule(),
        LockDisciplineRule(),
    ]


def rule_catalog() -> List[dict]:
    return [{"name": r.name, "description": r.description}
            for r in all_rules()]
