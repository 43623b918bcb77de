"""Static placement (paper baseline #2).

The port's copy of the reference's `core/placement/static.py` (numpy only).

"KV cache entries are written once without subsequent migration. New
entries fill HBM until capacity is reached, after which they are placed
in off-package DRAM, with no dynamic relocation."

This is exactly the base-class `place_new` plus no migrations.
"""

from repro_torch.core.placement.base import PlacementPolicy


class StaticPlacement(PlacementPolicy):
    name = "static"
    device_counterpart = "static"
