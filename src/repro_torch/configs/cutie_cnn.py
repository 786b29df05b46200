"""The paper's CIFAR-10 evaluation CNN (Table III) as a QAT model config.

7 conv layers (3x3, 128 channels) + 3 max-pools + avg-pool + FC, 1.1 GOp
per inference.  The first layer consumes the thermometer-encoded input
(3 color channels x M=42 -> 126 input channels, Table III's 126x32x32).

``width`` scales all channel counts for small training runs; the card
runs the full 128-channel net (`chip_smoke.py`, through
``CutiePipeline.compile``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CutieCNNConfig:
    width: int = 128               # paper: 128
    thermometer_m: int = 42        # 3*42 = 126 input channels
    n_classes: int = 10
    img_hw: int = 32
    act_mode: str = "ternary"      # ternary | binary  (TNN vs BNN twin)
    weight_mode: str = "ternary"   # ternary | binary
    # (op, out_ch_mult, pool) per layer, Table III
    layout = (
        ("conv", 1, None),
        ("conv", 1, None),
        ("conv", 1, ("max", 2)),
        ("conv", 1, None),
        ("conv", 1, ("max", 2)),
        ("conv", 1, None),
        ("conv", 1, ("max", 2)),
        ("conv", 1, ("avg", 4)),
    )

    @property
    def in_channels(self) -> int:
        return 3 * self.thermometer_m


CONFIG = CutieCNNConfig()
