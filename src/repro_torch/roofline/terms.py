"""Roofline terms for one NVIDIA H100 SXM (80 GB HBM3), the port's card.

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw

All three are seconds-per-step lower bounds; the max is the roofline step
time and its argmax is the bottleneck.  MODEL_FLOPS (6*N*D dense /
6*N_active*D MoE) over executed FLOPs measures how much of the compute is
"useful".

Constants: NVIDIA's H100 SXM5 datasheet (dense, no sparsity): 989.4
TFLOP/s bf16 tensor core, 1,979 TOP/s int8, 3.35 TB/s HBM3; NVLink 4 is
900 GB/s per GPU in both directions together, 450 GB/s each way.  The
reference's TPU v5e constants do not apply to the port.
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12          # bf16 FLOP/s per H100 SXM (dense)
PEAK_INT8_OPS = 1979e12      # int8 OP/s per H100 SXM (dense)
HBM_BW = 3.35e12             # bytes/s per card (HBM3)
NVLINK_BW = 450e9            # bytes/s per card, one direction (NVLink 4)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: how close the step is to pure compute."""
        return self.compute_s / max(self.step_s, 1e-30)


def roofline(flops: float, bytes_: float, wire_bytes: float = 0.0, *,
             peak: float = PEAK_FLOPS) -> Roofline:
    """``peak``: the card's rate for the operations' type (`PEAK_FLOPS`
    for bf16, `PEAK_INT8_OPS` for int8)."""
    return Roofline(
        compute_s=flops / peak,
        memory_s=bytes_ / HBM_BW,
        collective_s=wire_bytes / NVLINK_BW,
    )


def model_flops_train(n_params: int, n_tokens: int,
                      active_params: int | None = None) -> float:
    """6*N*D (fwd+bwd) with N = active params for MoE."""
    n = active_params if active_params is not None else n_params
    return 6.0 * n * n_tokens


def model_flops_infer(n_params: int, n_tokens: int,
                      active_params: int | None = None) -> float:
    n = active_params if active_params is not None else n_params
    return 2.0 * n * n_tokens
