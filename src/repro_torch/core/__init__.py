"""CUTIE core on tensors: codec, folding, quantizers, thermometer, engine."""

from repro_torch.core import codec, engine, folding, ternary, thermometer

__all__ = ["codec", "engine", "folding", "ternary", "thermometer"]
