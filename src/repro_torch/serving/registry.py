"""Multi-model registry: executors served by name, hot-swappable.

One engine serves many models concurrently; requests route by model
name.  Registering an existing name replaces the executor in place
(hot-swap): requests already queued under that name execute on the new
model at their next admission.

The reference also accepts the CNN compile path here (a Graph, a
CompileResult, a CutieProgram or a CutiePipeline, normalized to a
bucketed ``ProgramExecutor``); in the port that waits for ROADMAP.md §1
item 7, and only an `Executor` instance registers.
"""

from __future__ import annotations

from repro_torch.serving.executors import Executor


class ModelRegistry:
    def __init__(self):
        self._executors: dict[str, Executor] = {}

    # -- registration -------------------------------------------------------

    def register(self, name: str, source, **options) -> Executor:
        """Register the executor ``source`` under ``name``; returns it."""
        if not isinstance(source, Executor) or options:
            raise NotImplementedError(
                f"cannot register a {type(source).__name__}"
                f"{' with options ' + str(sorted(options)) if options else ''}"
                ": CNN programs and their serving options wait for the "
                "port's ProgramExecutor (ROADMAP.md §1 item 7); register an "
                "Executor such as LLMExecutor")
        self._executors[name] = source
        return source

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
