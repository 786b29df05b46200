"""`repro_torch.serving` — one scheduler-driven serving engine.

The whole serving plane sits behind :class:`CutieEngine`'s
submit → schedule → execute → stream lifecycle: pluggable schedulers
(FCFS / priority / deadline), a multi-model hot-swappable registry, and
first-class latency / queue-depth stats.  LLM decode memory is **paged**
(:mod:`repro_torch.serving.blocks`): block-granular allocation,
content-hash prefix reuse, LRU eviction and copy-on-write forks behind
`LLMExecutor`'s split `prefill()` / `decode()` paths.

Failure handling is first-class: :mod:`repro_torch.serving.faults`
provides a deterministic fault injector (`FaultPlan` / `FaultyExecutor`)
and the engine's recovery policy (`FaultPolicy`).

Not ported yet, each raising where it would be reached: the CNN
`ProgramExecutor` (ROADMAP.md §1 item 7), speculative decoding and the
serving-state snapshot (item 10 and item 8).
"""

from repro_torch.serving.blocks import (BlockPool, KVPagedStore,  # noqa: F401
                                        OutOfBlocks, PagedSequenceManager,
                                        PrefixCache)
from repro_torch.serving.engine import CutieEngine, percentiles  # noqa: F401
from repro_torch.serving.executors import (ExecutionReport,  # noqa: F401
                                           Executor)
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

__all__ = [
    "CutieEngine", "percentiles",
    "ModelRegistry",
    "Request", "RequestHandle", "RequestStatus", "RequestCancelled",
    "Scheduler", "FCFSScheduler", "PriorityScheduler", "DeadlineScheduler",
    "SCHEDULERS", "get_scheduler",
    "Executor", "ExecutionReport",
    "LLMExecutor", "ServerConfig", "ExistingPrefix", "PrefillResult",
    "BlockPool", "OutOfBlocks", "PrefixCache", "PagedSequenceManager",
    "KVPagedStore",
    "FaultPlan", "FaultPolicy", "FaultyExecutor", "FAULT_KINDS",
    "TransientFault", "DeviceLost", "PoisonedRequestError",
    "GarbageOutputError", "LoadShedError", "ModelQuarantinedError",
    "RequestTimeout",
]
