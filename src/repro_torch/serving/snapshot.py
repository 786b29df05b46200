"""Elastic serving-state checkpoint: kill a `CutieEngine`, restart it,
continue every in-flight decode bit-identically.

The port of the reference's `repro.serving.snapshot`, in the same
checkpoint format (`repro_torch.checkpoint`), so a snapshot written by
either package restores in the other: the state carries over (pages,
positions, block tables, the queue), while the sampling generator and
the bf16 forwards are each package's own.

What a snapshot holds, per snapshot-capable executor
(:meth:`~repro_torch.serving.llm.LLMExecutor.snapshot`):

* **array state** — paged KV pages (or the contiguous caches), slot
  positions, pending tokens, the sampling generator's state — stored as
  checkpoint leaves (bfloat16 pages ride the raw-bytes encoding; the
  trit KV codec's pages are already packed bytes and are stored as they
  are);
* **host bookkeeping** — slot residency, per-request emitted tokens and
  prompts, the `BlockPool` allocator (free list, refcounts, LRU cached
  set), the `PrefixCache` map, and every live sequence's block table —
  as JSON in the manifest's ``extra`` dict;
* **engine queue state** — queued (and retry-pending) requests with
  their values and metadata, so nothing submitted is lost across the
  restart.

Restore targets a *fresh* engine with the same models registered (same
configs/params — the checkpoint stores serving state, not weights).
Resident requests are re-materialized as RUNNING requests with new
handles; queued requests are resubmitted in their original order.  The
returned ``{old_uid: RequestHandle}`` map lets a driver that tracked
uids across the kill keep consuming results.

    save_serving_state(engine, "ckpt/serving")
    ...process dies...
    engine2 = build_engine_again()          # same models registered
    handles = restore_serving_state(engine2, "ckpt/serving")
    engine2.run()                           # continues bit-identically
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from repro_torch import checkpoint as ckpt
from repro_torch.serving.request import Request, RequestHandle, RequestStatus


def _encode_value(value) -> dict:
    a = np.asarray(value)
    return {"dtype": str(a.dtype), "shape": list(a.shape),
            "data": a.reshape(-1).tolist()}


def _decode_value(enc: dict) -> np.ndarray:
    return np.asarray(enc["data"], dtype=np.dtype(enc["dtype"])).reshape(
        enc["shape"])


def _request_meta(r: Request) -> dict:
    return {"uid": r.uid, "model": r.model, "priority": r.priority,
            "deadline": r.deadline, "tag": r.tag, "spec_k": r.spec_k,
            "timeout": r.timeout, "retries": r.retries, "seq": r.seq}


def _snapshot_executors(engine) -> tuple[dict, dict]:
    trees, metas = {}, {}
    for name, ex in engine.registry.items():
        if hasattr(ex, "snapshot"):
            tree, meta = ex.snapshot()
            trees[name] = tree
            metas[name] = meta
    return trees, metas


def save_serving_state(engine, root: str, step: int = 0, *,
                       keep: int = 3) -> str:
    """Atomically checkpoint ``engine``'s serving state under ``root``.

    Captures every snapshot-capable executor (`LLMExecutor`; one-shot
    `ProgramExecutor` models hold no cross-step state) plus the engine's
    queued and retry-pending requests.  Returns the checkpoint path.
    """
    trees, metas = _snapshot_executors(engine)
    queued = []
    pending = list(engine.scheduler._queued.values())
    for _, _, reqs in engine._retry:
        pending.extend(reqs)
    for r in sorted(pending, key=lambda r: r.seq):
        queued.append({**_request_meta(r),
                       "value": _encode_value(r.value)})
    resident = []
    for name, meta in metas.items():
        for uid in meta["slots"]:
            if uid is None:
                continue
            r = engine._requests.get(uid)
            if r is None:
                # admitted via executor.prefill() directly, not through
                # the engine; snapshot what the executor knows
                resident.append({"uid": uid, "model": name,
                                 "priority": 0, "deadline": None,
                                 "tag": None, "spec_k": None,
                                 "timeout": None, "retries": 0, "seq": 0})
            else:
                resident.append(_request_meta(r))
    extra = {"serving": {
        "executors": metas,
        "queued": queued,
        "resident": resident,
        "next_uid": engine._uid,
        "next_seq": engine._seq,
    }}
    return ckpt.save(root, step, trees, extra=extra, keep=keep)


def restore_serving_state(engine, root: str,
                          step: Optional[int] = None
                          ) -> dict[int, RequestHandle]:
    """Load a serving-state checkpoint into a freshly built engine.

    ``engine`` must have the same snapshot-capable models registered
    (same configs and params) as the engine that saved.  Returns
    ``{old_uid: handle}`` covering both re-materialized resident
    requests (same uid) and resubmitted queued requests (fresh uid).
    """
    template, _ = _snapshot_executors(engine)
    # read the manifest first so a model mismatch fails with a clear
    # error instead of a missing-leaf KeyError inside ckpt.restore
    step = ckpt.latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no serving checkpoint under {root}")
    with open(os.path.join(root, f"step_{step:09d}",
                           "manifest.json")) as f:
        manifest = json.load(f)
    state = manifest["extra"]["serving"]
    saved = set(state["executors"])
    if set(template) != saved:
        raise ValueError(
            f"registered snapshot-capable models {sorted(template)} do "
            f"not match the checkpoint's {sorted(saved)}; register the "
            "same models before restoring")
    tree, _ = ckpt.restore(root, template, step)
    for name, ex_tree in tree.items():
        engine.registry[name].restore(ex_tree, state["executors"][name])
    engine._uid = max(engine._uid, int(state["next_uid"]))
    engine._seq = max(engine._seq, int(state["next_seq"]))
    now = engine.clock()
    handles: dict[int, RequestHandle] = {}
    for rec in state["resident"]:
        uid = int(rec["uid"])
        prompts = state["executors"][rec["model"]]["prompts"]
        value = np.asarray(prompts[str(uid)], np.int32)
        req = Request(uid=uid, model=rec["model"], value=value,
                      priority=rec["priority"], deadline=rec["deadline"],
                      tag=rec["tag"], spec_k=rec["spec_k"],
                      timeout=rec["timeout"], retries=int(rec["retries"]),
                      seq=int(rec["seq"]), submit_t=now, schedule_t=now,
                      status=RequestStatus.RUNNING)
        engine._requests[uid] = req
        handle = RequestHandle(engine, req)
        engine._handles[uid] = handle
        handles[uid] = handle
        if req.timeout is not None:
            engine._timed.add(uid)
        if engine.obs.enabled:
            engine.obs.trace.thread_name(
                uid, f"req {uid} ({req.model}, restored)")
            engine.obs.trace.instant("restore", tid=uid, cat="request",
                                     model=req.model)
            engine.obs.trace.begin("execute", tid=uid, cat="request",
                                   model=req.model)
    for rec in state["queued"]:
        handle = engine.submit(
            _decode_value(rec["value"]), model=rec["model"],
            priority=rec["priority"], deadline=rec["deadline"],
            tag=rec["tag"], spec_k=rec["spec_k"], timeout=rec["timeout"])
        handles[int(rec["uid"])] = handle
    engine.obs.metrics.counter(
        "serving_restores_total",
        "serving-state checkpoints restored into this engine").inc()
    return handles
