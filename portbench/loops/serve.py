"""The serving loop: ``clients`` closed-loop clients, each sending its
next request once its last one has completed and it has thought for the
request's ``think_s``, through one engine that the loop steps.  The
first request of each client waits its ``think_s`` from the window's
start, so the clients arrive out of phase, and a step may admit several.

A request is sent at its client's send time.  The engine takes it when
the running step has returned (the loop drives one step at a time), and
its latency counts that wait.  Its first token is on the host when the
engine step that ran its prefill returns (the step samples it there);
its tokens reach the client when the step that finishes it returns.
"""

from __future__ import annotations

import time

from portbench import traffic as TR

#: how long the loop waits after the window for requests still running
DRAIN_S = 60.0


class Loop:
    def __init__(self, system, traffic: dict, sizes: dict, seed: int,
                 device):
        self.server, self.traffic = system, traffic
        self.vocab, self.seed = sizes["vocab_size"], seed
        self.requests: list[dict] = []
        self.spans: list[tuple] = []
        self._made = 0
        self._pending: list[dict] = []

    def _next(self) -> dict:
        """The next request of the mix (drawn in blocks as needed)."""
        if self._made == len(self._pending):
            self._pending = TR.requests(self.traffic, self.vocab, self.seed,
                                        self._made + 4 * self.traffic["block"])
        r = dict(self._pending[self._made])
        self._made += 1
        return r

    def _submit(self, req: dict, t_send: float) -> dict:
        t = time.perf_counter()
        req["handle"] = self.server.submit(req["prompt"])
        req["t_submit"] = t_send
        self.spans.append(("submit", t, time.perf_counter()))
        self.requests.append(req)
        return req

    def _step(self, live: list) -> list:
        t0 = time.perf_counter()
        self.server.step()
        now = time.perf_counter()
        self.spans.append(("step", t0, now))
        done = []
        for r in live:
            h = r["handle"]
            if "t_first" not in r and self.server.admitted(h):
                r["t_first"] = now
            if self.server.finished(h):
                r["t_done"] = now
                r["tokens"] = self.server.tokens(h)
                done.append(r)
        return done

    def warmup(self) -> None:
        """One block of the mix's prompt lengths, from a stream of their
        own, served by the same clients: every prefill shape and the full
        decode batch the window meets."""
        plens = TR.stratified_lengths(self.traffic["prompt_tokens"],
                                      self.traffic["block"])
        prompts = TR.warmup_prompts(self.traffic, self.vocab, self.seed,
                                    plens)
        live = []
        while prompts or live:
            while prompts and len(live) < self.traffic["clients"]:
                live.append({"handle": self.server.submit(prompts.pop())})
            done = self._step(live)
            live = [r for r in live if r not in done]
        self.requests, self.spans = [], []

    def window(self, seconds: float, trace=None, trace_s: float = 0.0
               ) -> dict:
        t_start = time.perf_counter()
        t_end = t_start + seconds
        trace_end = t_start + trace_s if trace is not None else None
        # each idle client's next request and the time it sends it
        idle = []
        for _ in range(self.traffic["clients"]):
            r = self._next()
            idle.append((t_start + r["think_s"], r))
        live = []

        def send(until: float) -> None:
            due = sorted((x for x in idle if x[0] <= until),
                         key=lambda x: x[0])
            idle[:] = [x for x in idle if x[0] > until]
            for t_send, r in due:
                live.append(self._submit(r, t_send))

        while time.perf_counter() < t_end:
            send(time.perf_counter())
            if live:
                for r in self._step(live):
                    live.remove(r)
                    nxt = self._next()
                    idle.append((r["t_done"] + nxt["think_s"], nxt))
            else:
                wait = min(t for t, _ in idle) - time.perf_counter()
                time.sleep(max(0.0, min(wait, t_end - time.perf_counter())))
            if trace_end is not None and time.perf_counter() >= trace_end:
                trace.stop()
                trace_end = None
        if trace_end is not None:
            trace.stop()
        send(t_end)
        give_up = time.perf_counter() + DRAIN_S
        while live and time.perf_counter() < give_up:
            for r in self._step(live):
                live.remove(r)
        return {"t_start": t_start, "t_end": t_end, "seconds": seconds}

    def close(self) -> None:
        """Drop every reference to the engine (handles hold it)."""
        for r in self.requests:
            r.pop("handle", None)
        self.server = None

    def tally(self, t_end: float) -> tuple[int, int]:
        """(requests sent in the window, those that failed or never
        finished)."""
        sent = [r for r in self.requests if r["t_submit"] < t_end]
        return len(sent), sum(1 for r in sent if not r.get("tokens"))
