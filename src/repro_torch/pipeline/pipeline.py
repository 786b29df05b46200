"""`CutiePipeline`: a compiled CUTIE program bound to a backend and device.

The ASIC compiles the network into its layer FIFO once, then runs the
whole program with the host asleep (paper §III, Fig. 3).  Here the
program's weights and thresholds are lowered onto the device once.  A
backend with ``build_program`` (``fused``) runs the whole program through
one function built per input shape and cached: one trunk-kernel launch
per fused segment.  Otherwise a run is a Python loop over the layers:
PyTorch runs eagerly, so the loop takes the place of the reference's
``lax.scan`` under ``jit``, and every layer is one kernel launch on the
current stream.

    pipe = CutiePipeline(prog)                        # cuda backend, card
    pipe = CutiePipeline.compile(graph, backend="fused")   # from a Graph
    y = pipe.run(x)                                   # trits out
    y, rows = pipe.run(x, tracer=SwitchingTracer())   # + per-layer stats
    energy = pipe.measure(x)                          # priced inference

Tracers with ``kernel_stats`` take their counts from the kernels
themselves (``emit_stats``), so a traced run launches the same kernels
and reads back one (3,) int32 row per layer; a tracer without it makes
even ``fused`` run layer by layer.

Multi-device execution is a constructor knob: ``mesh=`` accepts a
:class:`repro_torch.launch.cutie_mesh.MeshSpec` (or any spelling its
``parse`` takes: ``8``, ``"data:4,filter:2"``, ``"layer:4"``, a
``DeviceMesh``) and runs the program over the ranks of the process group
the caller initialized, one rank per mesh position: data-parallel over
the batch, filter-parallel over each layer's output channels, or
pipeline-parallel over the layers, bit-identical to unsharded execution.
Batch sizes and channel counts that do not divide the mesh are padded in
and cropped back out.

A bound `repro_torch.obs.Observability` (``compile(..., obs=...)`` or
``bind_obs``) records the pipeline's spans on its trace, on one track:
``compile`` with the compiler's stages and ``pipeline.lower`` inside it,
one ``run`` per run and one ``launch`` per kernel launch inside the run.
Unbound, a run reads no clock and builds no event: it pays one attribute
test, and a test before and after each launch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch.core import engine
from repro_torch.device import resolve_device
from repro_torch.pipeline import backends as B
from repro_torch.pipeline.tracer import SwitchingTracer, Tracer


def layer_out_shape(instr: engine.LayerInstr, in_shape) -> tuple:
    """Static shape inference for one compiled layer (conv + merged pool)."""
    n, h, w, _ = in_shape
    oh, ow = engine.conv_out_hw(instr, h, w)
    if instr.pool is not None:
        oh, ow = oh // instr.pool[1], ow // instr.pool[1]
    return (n, oh, ow, instr.weights.shape[-1])


def program_shapes(program: engine.CutieProgram, in_shape) -> list[tuple]:
    """Per-layer activation shapes: [input, after layer 0, ..., output]."""
    shapes = [tuple(in_shape)]
    for instr in program.layers:
        shapes.append(layer_out_shape(instr, shapes[-1]))
    return shapes


class CutiePipeline:
    """A compiled CUTIE program bound to an execution backend and device.

    ``device=None`` is the card (raises when there is none); pass
    ``device="cpu"`` for the plain PyTorch path on the CPU.  ``obs``
    binds an observability sink, as ``bind_obs`` does.
    """

    #: the observability sink; the no-op ``NULL`` until one is bound
    obs = _obs.NULL
    #: ``obs.trace`` while it records, else None: what a run tests
    _trace = None

    def __init__(self, program: engine.CutieProgram,
                 backend: str | B.Backend | None = None, device=None, *,
                 mesh=None, packed_collectives: bool = True,
                 microbatches: int | None = None, obs=None):
        if obs is not None:
            self.bind_obs(obs)
        program.validate()
        self.program = program
        self.device = resolve_device(device)
        self.backend = B.get_backend(backend)
        self.mesh_spec = None
        self._sharded = None
        self.scannable = False
        self._calls = 0                            # traced runs so far
        with self.obs.trace.span("pipeline.lower", cat=B.CAT):
            self._lower(program, mesh, packed_collectives, microbatches)
        self._programs: dict[tuple, object] = {}   # built program fns
        self._variants: set[tuple] = set()         # (input shape, traced)
        self._launch_args: dict[tuple, list] = {}  # input shape -> spans'

    def _lower(self, program, mesh, packed_collectives, microbatches):
        """Lower every layer onto the device, or onto the mesh's ranks."""
        if mesh is not None:
            from repro_torch.launch import cutie_mesh

            self.mesh_spec = cutie_mesh.MeshSpec.parse(mesh)
            if hasattr(self.backend, "build_program"):
                # mesh execution is per layer; the program-level build
                # (fused trunk kernels) is dropped on a mesh, as the
                # reference drops it: execution_plan() names the path
                import warnings

                warnings.warn(
                    f"backend {self.backend.name!r} builds whole-program "
                    "trunk kernels, but mesh= execution is per layer: the "
                    "program-level build is dropped on this mesh (fused "
                    "trunks do not shard yet; inter-layer collectives stay "
                    "5-trits/byte packed). Check pipe.execution_plan() for "
                    "the chosen path.", UserWarning, stacklevel=2)
            if self.mesh_spec.layer > 1:
                self._sharded = cutie_mesh.PipelinedExecution(
                    program, self.backend, self.mesh_spec, self.device,
                    microbatches=microbatches, packed=packed_collectives)
            else:
                self._sharded = cutie_mesh.ShardedExecution(
                    program, self.backend, self.mesh_spec, self.device,
                    packed=packed_collectives)
            self.scannable = self._sharded.scannable
            self._lowered = self._sharded.lowered
        elif microbatches is not None:
            raise ValueError("microbatches= only applies to pipeline-"
                             "parallel meshes (mesh=\"layer:N\")")
        else:
            self._lowered = [self.backend.lower(i, self.device)
                             for i in program.layers]

    def bind_obs(self, obs) -> None:
        """Record this pipeline's spans on ``obs.trace`` (an
        `repro_torch.obs.Observability`; ``obs.NULL`` stops recording)."""
        self.obs = obs
        self._trace = obs.trace if obs.trace.enabled else None

    @classmethod
    def compile(cls, source, *,
                instance: engine.CutieInstance = engine.GF22_SCM,
                backend: str | B.Backend | None = None, device=None,
                mesh=None, packed_collectives: bool = True,
                microbatches: int | None = None, obs=None,
                **compiler_options) -> "CutiePipeline":
        """Compile a network straight into a pipeline on ``device``.

        ``source`` is a :class:`repro_torch.compiler.Graph`, legalized,
        optimized and lowered by `repro_torch.compiler` with the per-pass
        cost report kept on ``pipeline.compile_result``, or an iterable of
        ``(w_float, bn_dict[, opts])`` tuples where ``opts`` are keyword
        arguments of :func:`repro_torch.core.engine.compile_layer`.
        ``compiler_options`` (e.g. ``optimize=False``, ``pad_to=128``)
        apply to a graph only; ``mesh``, ``packed_collectives`` and
        ``microbatches`` bind the pipeline to a mesh as the constructor
        does.  ``obs`` is bound before compiling: its trace records one
        ``compile`` span around the whole, with the compiler's stages and
        ``pipeline.lower`` inside it.
        """
        from repro_torch import compiler

        if compiler_options and not isinstance(source, compiler.Graph):
            raise TypeError("compiler options "
                            f"{sorted(compiler_options)} require a "
                            "repro_torch.compiler.Graph source")
        kw = dict(backend=backend, device=device, mesh=mesh,
                  packed_collectives=packed_collectives,
                  microbatches=microbatches, obs=obs)
        trace = (obs or _obs.NULL).trace
        with trace.span("compile", cat=B.CAT):
            if isinstance(source, compiler.Graph):
                result = compiler.compile_graph(
                    source, instance=instance, device=device, trace=trace,
                    **compiler_options)
                pipe = cls(result.program, **kw)
                pipe.compile_result = result
                return pipe
            instrs = []
            for spec in source:
                w, bn, *rest = spec
                instrs.append(engine.compile_layer(
                    w, bn, device=device, **(rest[0] if rest else {})))
            return cls(engine.CutieProgram(instrs, instance), **kw)

    # -- introspection ------------------------------------------------------

    @property
    def backend_name(self) -> str:
        return self.backend.name

    @property
    def n_layers(self) -> int:
        return len(self.program.layers)

    @property
    def batch_quantum(self) -> int:
        """Executed batches are padded to a multiple of this: the
        data-parallel degree, times the microbatch count on
        pipeline-parallel meshes (each data shard must split into whole
        microbatches).  1 when unsharded."""
        if self.mesh_spec is None:
            return 1
        return self.mesh_spec.data * getattr(self._sharded,
                                             "microbatches", 1)

    @property
    def n_jit_variants(self) -> int:
        """Distinct ``(input shape, traced)`` variants run so far, on
        every backend (on ``fused`` each is a built program) — the
        quantity a serving engine's batch bucketing keeps bounded; the
        reference's count of jit specializations."""
        return len(self._variants)

    def shapes(self, in_shape) -> list[tuple]:
        return program_shapes(self.program, in_shape)

    def execution_plan(self, in_shape=None, tracer: Tracer | None = None
                       ) -> dict:
        """How this pipeline will execute a run.

        ``mode`` is ``"sharded-per-layer"`` (a data/filter mesh, layer by
        layer with inter-layer collectives), ``"sharded-pipeline"`` (a
        layer mesh: one trunk stage per rank on a ring), ``"program"``
        (the backend's whole-program build: one trunk-kernel launch per
        fused segment) or ``"per-layer"`` (one kernel launch per layer).
        ``fallback`` is ``"mesh"`` when a program-level backend drops to
        per-layer execution on a data/filter mesh (a layer mesh runs its
        stages layer by layer on every backend), ``"tracer"`` when a tracer
        without a kernel-side mode drops it, else None.  A meshed plan
        also carries ``collectives`` (``"packed"`` or ``"dense"``),
        ``wire`` (the process group's backend, ``"nccl"``, or ``"gloo,
        host-staged"`` for card tensors copied through the host) and, on
        a layer mesh, ``pipeline`` (the schedule's accounting).  With
        ``in_shape`` and a backend that plans trunks, ``segments`` lists
        each segment's layer range, whether it is fused, its priced L2
        residency (``l2_bytes``, the port's name for the reference's
        ``vmem_bytes``) and the planner's reason.
        """
        has_program = hasattr(self.backend, "build_program")
        kernel_stats = tracer is not None and tracer.kernel_stats
        mode, fallback = self._mode(tracer), None
        if self._sharded is not None:
            wire = "5-trits/byte packed" if self._sharded.packed else "dense"
            if mode == "sharded-pipeline":
                reason = (f"layer mesh axis: one trunk stage per rank, "
                          f"microbatches streamed through a send/recv "
                          f"ring ({wire} activations)")
            else:
                reason = (f"mesh= requested; per-layer execution with "
                          f"{wire} inter-layer collectives")
                if has_program:
                    fallback = "mesh"
                    reason += ("; the backend's program-level build (fused "
                               "trunk kernels) is dropped: fused trunks do "
                               "not shard yet")
        elif mode == "program":
            reason = (f"backend {self.backend_name!r} provides "
                      "build_program (one trunk-kernel launch per fused "
                      "segment)")
            if kernel_stats:
                reason += "; tracer rows come from in-kernel counters"
        else:
            reason = "eager loop over the layer FIFO, one kernel per layer"
            if tracer is not None:
                reason += ("; tracer rows from in-kernel counters"
                           if kernel_stats else
                           "; tracer reads every layer's activations")
            if has_program:
                fallback = "tracer"
                reason = (f"tracer {type(tracer).__name__} has no "
                          "kernel-side mode (kernel_stats=False); the "
                          f"program-level build is dropped: {reason}")
        plan = {"mode": mode, "backend": self.backend_name,
                "device": str(self.device),
                "mesh": str(self.mesh_spec) if self.mesh_spec else None,
                "scannable": self.scannable, "reason": reason,
                "fallback": fallback}
        if self._sharded is not None:
            plan["collectives"] = ("packed" if self._sharded.packed
                                   else "dense")
            plan["wire"] = self._sharded.wire.name
            if hasattr(self._sharded, "schedule_stats"):
                plan["pipeline"] = self._sharded.schedule_stats()
        if in_shape is not None and hasattr(self.backend, "plan"):
            plan["segments"] = [
                {"start": s.start, "stop": s.stop, "fused": s.fused,
                 "l2_bytes": s.l2_bytes, "reason": s.reason or None}
                for s in self.backend.plan(self.program, tuple(in_shape))]
        return plan

    def _mode(self, tracer: Tracer | None) -> str:
        """``execution_plan``'s ``mode`` of a run with ``tracer``."""
        if self._sharded is not None:
            return ("sharded-pipeline" if self.mesh_spec.layer > 1
                    else "sharded-per-layer")
        if (hasattr(self.backend, "build_program")
                and (tracer is None or tracer.kernel_stats)):
            return "program"
        return "per-layer"

    def __repr__(self) -> str:
        mesh = f", mesh={self.mesh_spec}" if self.mesh_spec else ""
        return (f"CutiePipeline(layers={self.n_layers}, "
                f"backend={self.backend_name!r}, device={self.device}"
                f"{mesh})")

    # -- execution ----------------------------------------------------------

    def _program(self, in_shape, tracer: Tracer | None):
        """The backend's whole-program function for ``in_shape``, built
        once and cached; None when the run goes layer by layer."""
        if not hasattr(self.backend, "build_program"):
            return None
        if tracer is not None and not tracer.kernel_stats:
            return None
        key = (tuple(in_shape), tracer is not None)
        if key not in self._programs:
            self._programs[key] = self.backend.build_program(
                self.program, tuple(in_shape), emit_stats=tracer is not None)
        return self._programs[key]

    def run(self, x, tracer: Tracer | None = None):
        """Execute the whole program on input trits x (N, H, W, C) int8.

        Returns the final trit tensor; with a tracer, also the tracer's
        per-layer rows: ``(out, rows)``.

        With a recording trace bound (``bind_obs``) the run records one
        ``run`` span: ``call`` (this pipeline's traced runs, counted from
        1), ``n`` and ``mode`` (``execution_plan``'s).  Inside it, an
        unsharded run records one ``launch`` span per kernel launch (the
        `_layer_launch_args`, and ``call``); a meshed run records the
        ``run`` span only.
        """
        x = torch.as_tensor(x, device=self.device).to(torch.int8)
        if x.dim() != 4:
            raise ValueError(f"expected (N, H, W, C) trits, got "
                             f"{tuple(x.shape)}")
        tr = self._trace
        if tr is None:
            return self._run(x, tracer, None, 0)
        self._calls += 1
        tr.begin("run", cat=B.CAT, call=self._calls, n=x.shape[0],
                 mode=self._mode(tracer))
        try:
            return self._run(x, tracer, tr, self._calls)
        finally:
            tr.end("run", cat=B.CAT)

    def _run(self, x, tracer: Tracer | None, trace, call: int):
        if self._sharded is not None:
            if tracer is not None:
                raise NotImplementedError(
                    "tracers are not supported on meshed pipelines yet; "
                    "run an unsharded pipeline for stats/energy tracing")
            self._sharded.wire.check_shape(x.shape)
            n = x.shape[0]
            x = self._sharded.pad_inputs(x)
            self._variants.add((tuple(x.shape), False))
            return self._sharded.crop(self._sharded.run(x), n)
        self._variants.add((tuple(x.shape), tracer is not None))
        if trace is not None and self.backend.kernel is None:
            trace = None                        # `ref`: no launch to span
        args = (None if trace is None
                else self._layer_launch_args(tuple(x.shape)))
        fn = self._program(x.shape, tracer)
        if fn is not None:
            out, counts = fn(self._lowered, x, trace, call, args)
            if tracer is None:
                return out
            return out, tracer.finalize_counts(
                self.program, counts.cpu().numpy(),
                self.shapes(tuple(x.shape)))
        cur, recs = x, []
        for i, (lw, instr) in enumerate(zip(self._lowered,
                                            self.program.layers)):
            if trace is not None:
                t = trace.clock()
            if tracer is not None and tracer.kernel_stats:
                y, row = self.backend.apply_with_stats(lw, cur, instr)
                recs.append(row)
            else:
                y = self.backend.apply(lw, cur, instr)
            if trace is not None:
                trace.complete("launch", t, trace.clock(), cat=B.CAT,
                               args={"call": call, **args[i]})
            if tracer is not None and not tracer.kernel_stats:
                recs.append(tracer.trace_layer(cur, y, instr))
            cur = y
        if tracer is None:
            return cur
        shapes = self.shapes(tuple(x.shape))
        if tracer.kernel_stats:
            counts = (torch.stack(recs).cpu().numpy() if recs
                      else np.zeros((0, 3), np.int32))
            return cur, tracer.finalize_counts(self.program, counts, shapes)
        recs = [{k: v.cpu().numpy() for k, v in r.items()} for r in recs]
        return cur, tracer.finalize(self.program, recs, shapes)

    def _layer_launch_args(self, in_shape: tuple) -> list[dict]:
        """Each layer's ``launch`` span args for an input of ``in_shape``,
        worked out once per shape: ``layer``, ``kernel`` (the backend's
        ``LAUNCHES`` key), the input's ``n, h, w, cin``, ``cout`` and
        ``pool`` (``"max2"``, or None)."""
        if in_shape not in self._launch_args:
            shapes = self.shapes(in_shape)
            args = []
            for i, instr in enumerate(self.program.layers):
                n, h, w, cin = shapes[i]
                pool = instr.pool and f"{instr.pool[0]}{instr.pool[1]}"
                args.append(dict(layer=i, kernel=self.backend.kernel, n=n,
                                 h=h, w=w, cin=cin, cout=shapes[i + 1][3],
                                 pool=pool))
            self._launch_args[in_shape] = args
        return self._launch_args[in_shape]

    # -- measurement --------------------------------------------------------

    def measure(self, x, params=None) -> dict:
        """Run and price every layer with the calibrated energy model.

        Per-layer rows, totals (energy per inference, avg and peak
        TOp/s/W) and the final trit tensor under ``"final"``; the network
        executes once, with the switching counts from the kernels.
        """
        from repro_torch.energy import model as E

        params = params or E.EnergyParams(self.program.instance.technology)
        out, rows = self.run(x, tracer=SwitchingTracer())
        res = E.network_energy(rows, params)
        res["final"] = out
        return res

    # -- serving ------------------------------------------------------------

    def engine(self, scheduler="fcfs", *, model: str = "default",
               buckets=None, head=None, tracer: Tracer | None = None,
               trace: bool = True):
        """A `CutieEngine` serving this pipeline under ``model``.

        One submit -> schedule -> execute -> stream surface: pluggable
        scheduler (``"fcfs"`` | ``"priority"`` | ``"deadline"`` or a
        Scheduler instance), batch bucketing (program variants bounded
        by ``buckets``), per-request handles with cancellation, and
        first-class latency/energy stats.  Register further models on
        the returned engine to serve them concurrently.
        """
        from repro_torch.serving.engine import CutieEngine

        eng = CutieEngine(scheduler, trace=trace)
        eng.register(model, self, buckets=buckets, head=head, tracer=tracer)
        return eng
