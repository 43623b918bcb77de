"""The simulator's placement policies by name (`POLICIES`); the
port's copy of the reference's `core/placement/__init__.py`."""

from repro_torch.core.placement.base import (
    PlacementPolicy, HBM, DRAM, UNALLOC,
)
from repro_torch.core.placement.unlimited import UnlimitedHBM
from repro_torch.core.placement.static import StaticPlacement
from repro_torch.core.placement.reactive import ReactiveLRU
from repro_torch.core.placement.quest_pages import QuestPages
from repro_torch.core.placement.sa_guided import SAGuided
from repro_torch.core.placement.belady import BeladyOracle
from repro_torch.core.placement.cost_aware import CostAwareHysteresis

POLICIES = {
    "unlimited": UnlimitedHBM,
    "static": StaticPlacement,
    "reactive": ReactiveLRU,
    "quest": QuestPages,
    "sa": SAGuided,
    "belady": BeladyOracle,
    "cost_aware": CostAwareHysteresis,
}

__all__ = [
    "PlacementPolicy", "HBM", "DRAM", "UNALLOC", "POLICIES",
    "UnlimitedHBM", "StaticPlacement", "ReactiveLRU", "QuestPages",
    "SAGuided", "BeladyOracle", "CostAwareHysteresis",
]
