"""CUTIE compiler passes on tensors.  Only trunk segmentation is ported so
far; the graph compiler (graph, legalize, optimize, report, compile)
comes with its own slice."""

from repro_torch.compiler.trunks import (DEFAULT_L2_BUDGET, Trunk,
                                         plan_segments, plan_stages,
                                         segment_shapes, trunk_cin,
                                         trunk_l2_bytes)

__all__ = ["DEFAULT_L2_BUDGET", "Trunk", "plan_segments", "plan_stages",
           "segment_shapes", "trunk_cin", "trunk_l2_bytes"]
