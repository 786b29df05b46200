"""CUTIE execution on PyTorch: run -> measure over pluggable backends."""

from repro_torch.launch.cutie_mesh import MeshSpec
from repro_torch.pipeline.backends import (Backend, CudaBackend,
                                           FusedBackend, PackedBackend,
                                           RefBackend, available_backends,
                                           get_backend)
from repro_torch.pipeline.pipeline import (CutiePipeline, layer_out_shape,
                                           program_shapes)
from repro_torch.pipeline.tracer import StatsTracer, SwitchingTracer, Tracer

__all__ = [
    "Backend", "RefBackend", "CudaBackend", "PackedBackend", "FusedBackend",
    "available_backends", "get_backend",
    "CutiePipeline", "layer_out_shape", "program_shapes",
    "MeshSpec",
    "Tracer", "StatsTracer", "SwitchingTracer",
]
