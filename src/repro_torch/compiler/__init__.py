"""`repro_torch.compiler`: the legalizing, optimizing graph compiler for
CUTIE, and trunk segmentation.

The front door from layer graphs (conv / dense / pool / residual add over
trit activations) to bit-true :class:`repro_torch.core.engine.CutieProgram`s:

    g = compiler.Graph(in_channels=6, in_hw=(12, 12))
    g.conv(w, bn, pool=("max", 2))
    g.dense(w_head)
    result = compiler.compile_graph(g)
    print(result.cost_table())

See `compile` for the pass pipeline, `graph` for the IR, `legalize` and
`optimize` for the passes, `report` for the static cost model and
`trunks` for the ``fused`` backend's segments (budgeted by the card's L2,
``DEFAULT_L2_BUDGET``, where the reference budgets a TPU's VMEM).
"""

from repro_torch.compiler.compile import (CompileResult, CompilerOptions,
                                          compile_graph, lower_graph)
from repro_torch.compiler.graph import Graph, GraphError, Node
from repro_torch.compiler.optimize import (eliminate_dead_channels,
                                           fold_constant_thresholds,
                                           pad_program_channels)
from repro_torch.compiler.report import cost_table, program_cost
from repro_torch.compiler.trunks import (DEFAULT_L2_BUDGET, Trunk,
                                         plan_segments, plan_stages,
                                         segment_shapes, trunk_cin,
                                         trunk_l2_bytes)

__all__ = [
    "CompileResult", "CompilerOptions", "DEFAULT_L2_BUDGET", "Graph",
    "GraphError", "Node", "Trunk", "compile_graph", "lower_graph",
    "eliminate_dead_channels", "fold_constant_thresholds",
    "pad_program_channels", "plan_segments", "plan_stages",
    "segment_shapes", "trunk_cin", "trunk_l2_bytes", "cost_table",
    "program_cost",
]
