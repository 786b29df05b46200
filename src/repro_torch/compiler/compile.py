"""The compiler's pass pipeline: Graph -> legalize -> lower -> optimize ->
CutieProgram.

    from repro_torch import compiler

    g = compiler.Graph(in_channels=6, in_hw=(12, 12))
    g.conv(w0, bn0, pool=("max", 2))
    g.dense(w_head)
    result = compiler.compile_graph(g)          # CompileResult, on the card
    print(result.cost_table())                  # per-pass predicted cost
    pipe = result.pipeline(backend="fused")
    eng = result.serve("net")                   # a CutieEngine serving it

(or in one step: ``CutiePipeline.compile(g, backend="fused")``.)

`compile_graph` runs the fixed legalization pipeline (ternarize, pool fusion,
dense lowering, residual lowering), lowers the conv chain through
``engine.compile_layer`` on ``device`` (``None`` is the card, as for
every entry point of the port), then, unless ``optimize=False``, the
exact sparsity passes (threshold constant folding, dead-channel
elimination) and the optional TCU-width channel padding.  After every
stage it snapshots the static cost model (`repro_torch.compiler.report`),
so ``CompileResult.cost_table()`` shows ops, sparsity, predicted energy
and DRAM traffic before and after each pass.  The reference is
`repro.compiler.compile`: the same graph gives the same program.

Given a `repro_torch.obs.TraceRecorder` as ``trace``, the stages record
their spans where their work happens: ``compile.lower`` (`lower_graph`),
one span per optimization pass under its name in ``reports``,
``compile.report`` around each cost snapshot and ``compile.validate``.
"""

from __future__ import annotations

import dataclasses

from repro_torch import obs as _obs
from repro_torch.compiler import legalize, optimize, report
from repro_torch.compiler.graph import Graph
from repro_torch.core import engine
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class CompilerOptions:
    optimize: bool = True          # run exact sparsity passes
    pad_to: int | None = None      # zero-pad internal edges to this width
    batch: int = 1                 # batch dim used for the cost report
    energy_params: object = None   # energy.model.EnergyParams | None


@dataclasses.dataclass
class CompileResult:
    program: engine.CutieProgram
    graph: Graph                   # final legalized (linear) graph
    reports: list[dict]            # [{"pass": name, "cost": {...}}, ...]
    removed_channels: list[int]    # per-layer dead channels eliminated
    folded_channels: int           # channels proven constant

    @property
    def in_shape(self) -> tuple:
        h, w = self.graph.in_hw
        return (1, h, w, self.graph.in_channels)

    def cost_table(self) -> str:
        return report.cost_table(self.reports)

    @property
    def ops_reduction(self) -> float:
        """Fractional op-count reduction from the optimization passes
        (excluding TCU-width padding, which adds ops on purpose)."""
        costs = {r["pass"]: r["cost"] for r in self.reports}
        base = costs["lowered"]["ops"]
        opt = costs.get("dead-channel-elim", costs["lowered"])["ops"]
        return 1.0 - opt / base if base else 0.0

    def pipeline(self, backend=None, *, device=None):
        """Bind the compiled program to an execution backend on
        ``device`` (the card by default), keeping this result attached as
        ``pipe.compile_result``."""
        from repro_torch.pipeline import CutiePipeline

        pipe = CutiePipeline(self.program, backend=backend, device=device)
        pipe.compile_result = self
        return pipe

    def serve(self, name: str = "default", *, engine=None,
              scheduler="fcfs", backend=None, device=None,
              **executor_options):
        """Register the compiled program with a serving engine.

        The compiler-side entry point to `repro_torch.serving`: compile a
        Graph, then ``result.serve("resnet", engine=eng)`` to publish
        (or hot-swap) it under a model name, bound to ``backend`` on
        ``device`` (the card by default).  Creates a fresh `CutieEngine`
        with ``scheduler`` when ``engine`` is None; returns the engine
        either way.
        """
        from repro_torch.serving.engine import CutieEngine

        eng = engine if engine is not None else CutieEngine(scheduler)
        eng.register(name, self.pipeline(backend, device=device),
                     **executor_options)
        return eng


#: the trace category of the compiler's spans
CAT = "compile"


def lower_graph(graph: Graph,
                instance: engine.CutieInstance = engine.GF22_SCM, *,
                device=None, trace=None) -> tuple[engine.CutieProgram, Graph]:
    """Legalization half of the compiler: Graph -> (program, linear
    graph), the program's tensors on ``device``; one ``compile.lower``
    span on ``trace`` (a `repro_torch.obs.TraceRecorder`) when given."""
    dev = resolve_device(device)
    tr = trace if trace is not None else _obs.NULL.trace
    with tr.span("compile.lower", cat=CAT):
        graph.infer_shapes()                   # early structural validation
        g = legalize.ternarize_weights(graph)
        g = legalize.fuse_pooling(g)
        g = legalize.lower_dense(g, instance)
        g = legalize.lower_residual(g)
        order = legalize.linearize(g)
        instrs = []
        for name in order:
            node = g.nodes[name]
            instrs.append(engine.compile_layer(
                node.weights, node.bn, stride=node.stride,
                padding=node.padding, pool=node.pool,
                delta_ratio=node.delta_ratio, device=dev))
    return engine.CutieProgram(instrs, instance), g


def compile_graph(graph: Graph,
                  instance: engine.CutieInstance = engine.GF22_SCM,
                  options: CompilerOptions | None = None, *,
                  device=None, trace=None, **kwargs) -> CompileResult:
    """Compile a layer graph into a validated, optimized CutieProgram on
    ``device``, recording the stages' spans on ``trace`` (a
    `repro_torch.obs.TraceRecorder`) when given."""
    if options is not None and kwargs:
        raise TypeError(f"pass compiler options either as options= or as "
                        f"keywords, not both (got options= plus "
                        f"{sorted(kwargs)})")
    opts = options or CompilerOptions(**kwargs)
    tr = trace if trace is not None else _obs.NULL.trace
    program, g = lower_graph(graph, instance, device=device, trace=tr)
    h, w = g.in_hw
    in_shape = (opts.batch, h, w, g.in_channels)

    def validate(prog):
        with tr.span("compile.validate", cat=CAT):
            prog.validate(in_shape=in_shape)

    def snap(name, prog):
        with tr.span("compile.report", cat=CAT, after=name):
            return {"pass": name,
                    "cost": report.program_cost(prog, in_shape,
                                                opts.energy_params)}

    validate(program)
    reports = [snap("lowered", program)]
    removed, folded = [0] * len(program.layers), 0
    if opts.optimize:
        with tr.span("fold-thresholds", cat=CAT):
            program, folded = optimize.fold_constant_thresholds(program)
        reports.append(snap("fold-thresholds", program))
        with tr.span("dead-channel-elim", cat=CAT):
            program, removed = optimize.eliminate_dead_channels(program)
        reports.append(snap("dead-channel-elim", program))
    if opts.pad_to is not None:
        with tr.span("pad-channels", cat=CAT):
            program = optimize.pad_program_channels(program, opts.pad_to)
        reports.append(snap("pad-channels", program))
    validate(program)
    return CompileResult(program=program, graph=g, reports=reports,
                         removed_channels=removed, folded_channels=folded)
