"""Multi-model registry: compiled programs served by name, hot-swappable.

One engine serves many models concurrently; requests route by model
name.  ``register`` accepts anything on the compile path — a
`repro_torch.compiler.Graph` (compiled via the graph compiler), a
`CompileResult`, a raw `CutieProgram`, an already-bound `CutiePipeline`,
or a custom `Executor` — and normalizes it to an executor.

Registering an existing name replaces the executor in place (hot-swap):
requests already queued under that name execute on the new model at
their next admission.  The swapped-in model must accept the same input
shape as any still-queued traffic, since inputs were validated against
the old executor at submit time.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.serving.executors import Executor, ProgramExecutor


class ModelRegistry:
    def __init__(self):
        self._executors: dict[str, Executor] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, source, *, backend=None,
                 buckets: Optional[Sequence[int]] = None, head=None,
                 tracer=None, instance=None, mesh=None, device=None,
                 **compiler_options) -> Executor:
        """Register ``source`` under ``name``; returns its executor.

        ``backend``/``buckets``/``head``/``tracer``/``mesh`` configure
        the ProgramExecutor built for program-like sources (``mesh`` runs
        the model sharded over the ranks of an initialized process group
        — data/filter/layer axes, packed 5-trits/byte inter-rank
        collectives; see `repro_torch.launch.cutie_mesh`); ``device`` is
        where a program, compile result or graph is bound (the card by
        default); ``instance``/``compiler_options`` apply to the Graph
        compile path only.  An Executor instance is registered as-is.
        Buckets round up to the meshed pipeline's batch quantum (data
        degree x microbatches).
        """
        executor = self._build(source, backend=backend, buckets=buckets,
                               head=head, tracer=tracer, instance=instance,
                               mesh=mesh, device=device, **compiler_options)
        self._executors[name] = executor
        return executor

    def _build(self, source, *, backend, buckets, head, tracer, instance,
               mesh=None, device=None, **compiler_options) -> Executor:
        if isinstance(source, Executor):
            return source

        from repro_torch import compiler
        from repro_torch.core import engine as core_engine
        from repro_torch.pipeline import CutiePipeline

        if isinstance(source, CutiePipeline):
            pipe = source
        elif isinstance(source, core_engine.CutieProgram):
            pipe = CutiePipeline(source, backend=backend, device=device)
        elif isinstance(source, compiler.CompileResult):
            pipe = source.pipeline(backend, device=device)
        elif isinstance(source, compiler.Graph):
            kw = dict(compiler_options, backend=backend, device=device)
            if instance is not None:
                kw["instance"] = instance
            pipe = CutiePipeline.compile(source, **kw)
        else:
            raise TypeError(
                f"cannot register a {type(source).__name__}: expected "
                "a Graph, CompileResult, CutieProgram, CutiePipeline "
                "or Executor")
        return ProgramExecutor(pipe, buckets=buckets, head=head,
                               tracer=tracer, mesh=mesh)

    def unregister(self, name: str) -> Executor:
        if name not in self._executors:
            raise ValueError(f"unknown model {name!r}")
        return self._executors.pop(name)

    # -- lookup -------------------------------------------------------------

    def __getitem__(self, name: str) -> Executor:
        try:
            return self._executors[name]
        except KeyError:
            raise ValueError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._executors) or '(none)'}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._executors

    def __len__(self) -> int:
        return len(self._executors)

    def names(self) -> list[str]:
        return sorted(self._executors)

    def items(self):
        return list(self._executors.items())
