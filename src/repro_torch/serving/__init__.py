"""`repro_torch.serving` — one scheduler-driven serving engine.

The whole serving plane sits behind :class:`CutieEngine`'s
submit → schedule → execute → stream lifecycle: pluggable schedulers
(FCFS / priority / deadline), a multi-model hot-swappable registry, and
first-class latency / queue-depth stats.  Compiled CNN programs serve
through the bucketed `ProgramExecutor`.  LLM decode memory is **paged**
(:mod:`repro_torch.serving.blocks`): block-granular allocation,
content-hash prefix reuse, LRU eviction and copy-on-write forks behind
`LLMExecutor`'s split `prefill()` / `decode()` paths.

Failure handling is first-class: :mod:`repro_torch.serving.faults`
provides a deterministic fault injector (`FaultPlan` / `FaultyExecutor`)
and the engine's recovery policy (`FaultPolicy`), while
:mod:`repro_torch.serving.snapshot` checkpoints the whole serving state
so a killed engine resumes in-flight decodes bit-identically.
:mod:`repro_torch.serving.spec` (`SpecExecutor`) is speculative decoding
over the same paged state.  ``register(..., mesh=)`` serves a compiled
CNN program sharded over the ranks of a process group
(`repro_torch.launch.cutie_mesh`).
"""

from repro_torch.serving.blocks import (BlockPool, KVPagedStore,  # noqa: F401
                                        OutOfBlocks, PagedSequenceManager,
                                        PrefixCache)
from repro_torch.serving.engine import CutieEngine, percentiles  # noqa: F401
from repro_torch.serving.executors import (DEFAULT_BUCKETS,  # noqa: F401
                                           ExecutionReport, Executor,
                                           ProgramExecutor)
from repro_torch.serving.faults import (FAULT_KINDS, DeviceLost,  # noqa: F401
                                        FaultPlan, FaultPolicy,
                                        FaultyExecutor, GarbageOutputError,
                                        LoadShedError, ModelQuarantinedError,
                                        PoisonedRequestError, RequestTimeout,
                                        TransientFault)
from repro_torch.serving.llm import (ExistingPrefix, LLMExecutor,  # noqa: F401
                                     PrefillResult, ServerConfig)
from repro_torch.serving.registry import ModelRegistry  # noqa: F401
from repro_torch.serving.request import (Request,  # noqa: F401
                                         RequestCancelled, RequestHandle,
                                         RequestStatus)
from repro_torch.serving.scheduler import (SCHEDULERS,  # noqa: F401
                                           DeadlineScheduler, FCFSScheduler,
                                           PriorityScheduler, Scheduler,
                                           get_scheduler)
from repro_torch.serving.snapshot import (  # noqa: F401
    restore_serving_state, save_serving_state)
from repro_torch.serving.spec import SpecConfig, SpecExecutor  # noqa: F401

__all__ = [
    "CutieEngine", "percentiles",
    "ModelRegistry",
    "Request", "RequestHandle", "RequestStatus", "RequestCancelled",
    "Scheduler", "FCFSScheduler", "PriorityScheduler", "DeadlineScheduler",
    "SCHEDULERS", "get_scheduler",
    "Executor", "ExecutionReport", "ProgramExecutor", "DEFAULT_BUCKETS",
    "LLMExecutor", "ServerConfig", "ExistingPrefix", "PrefillResult",
    "BlockPool", "OutOfBlocks", "PrefixCache", "PagedSequenceManager",
    "KVPagedStore",
    "FaultPlan", "FaultPolicy", "FaultyExecutor", "FAULT_KINDS",
    "TransientFault", "DeviceLost", "PoisonedRequestError",
    "GarbageOutputError", "LoadShedError", "ModelQuarantinedError",
    "RequestTimeout",
    "save_serving_state", "restore_serving_state",
    "SpecConfig", "SpecExecutor",
]
