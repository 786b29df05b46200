"""llava-next-mistral-7b on the port: the seeded float decoder handed to
the port in its serving form (every projection ``ternary_packed``), then
served text only through ``CutieEngine`` and ``LLMExecutor`` with paged
KV and the prefix cache on.

The port has no entry that takes a float parameter tree to its serving
form, so `pack` spells the serving branch of
``repro_torch.models.common.linear_init`` with the port's own TWN and
codec functions.  The vision tower is a stub in the port and its
projector is never read on the text serve path, so it is not built.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import weights


def arch(sizes: dict):
    from repro_torch.configs import llava_next_mistral_7b as published

    return published.CONFIG.replace(
        n_layers=sizes["num_hidden_layers"], d_model=sizes["hidden_size"],
        n_heads=sizes["num_attention_heads"],
        n_kv=sizes["num_key_value_heads"], d_head=sizes["head_dim"],
        d_ff=sizes["intermediate_size"], vocab=sizes["vocab_size"],
        rope_theta=sizes["rope_theta"],
        tie_embeddings=sizes["tie_word_embeddings"], quant=sizes["quant"],
        dtype=sizes["dtype"])


def shape(sizes: dict) -> dict:
    """The sizes the yardstick's counts take (`portbench.roofline`)."""
    return {"d_model": sizes["hidden_size"],
            "n_layers": sizes["num_hidden_layers"],
            "n_heads": sizes["num_attention_heads"],
            "n_kv": sizes["num_key_value_heads"], "d_head": sizes["head_dim"],
            "d_ff": sizes["intermediate_size"], "vocab": sizes["vocab_size"],
            "rope_theta": sizes["rope_theta"],
            "rms_norm_eps": sizes["rms_norm_eps"]}


def pack(w: torch.Tensor) -> dict:
    """A bf16 (K, N) projection in the port's serving form."""
    from repro_torch.core import codec
    from repro_torch.core import ternary as T

    wf = w.to(torch.float32)
    trits = T.ternarize(wf, T.twn_delta(wf, axis=(0,)))
    alpha = T.twn_scale(wf, trits, axis=(0,)).reshape(-1)
    return {"w_packed": codec.pack_rows(trits.T.to(torch.int8)).T.contiguous(),
            "scale": alpha.to(torch.float32)}


def params(sizes: dict, seed: int, device) -> dict:
    from repro_torch.models import transformer as TF

    cfg = arch(sizes)
    dims = shape(sizes)
    vp = TF.vocab_padded(cfg)
    embed = weights.decoder_embed(dims, seed, device)
    head = weights.decoder_head(dims, seed, device)
    pad = vp - dims["vocab"]
    p = {"embed": torch.nn.functional.pad(embed, (0, 0, 0, pad)),
         "head": torch.nn.functional.pad(head, (0, pad)),
         "ln_f": {"scale": torch.ones(dims["d_model"], dtype=torch.bfloat16,
                                      device=device)}, "layers": []}
    for i in range(dims["n_layers"]):
        w = weights.decoder_layer(dims, seed, i, device)
        ones = {"scale": torch.ones(dims["d_model"], dtype=torch.bfloat16,
                                    device=device)}
        p["layers"].append({
            "ln1": ones, "ln2": {"scale": ones["scale"].clone()},
            "attn": {"wq": pack(w["q"]), "wk": pack(w["k"]),
                     "wv": pack(w["v"]), "wo": pack(w["o"])},
            "mlp": {"gate": pack(w["gate"]), "up": pack(w["up"]),
                    "down": pack(w["down"])}})
        del w
    return p


class Server:
    """The engine and executor that the window drives."""

    def __init__(self, sizes: dict, traffic: dict, seed: int, device):
        from repro_torch.serving import CutieEngine, LLMExecutor, ServerConfig
        from repro_torch.serving.request import RequestStatus

        out = traffic["output_tokens"]
        if out["dist"] != "fixed":
            raise ValueError("LLMExecutor generates one max_new_tokens for "
                             "every request: the traffic needs a fixed "
                             "output length")
        self._queued = RequestStatus.QUEUED
        self._ok = RequestStatus.DONE
        self.cfg = arch(sizes)
        serve = sizes["serve"]
        self.scfg = ServerConfig(
            max_len=serve["max_len"], n_slots=serve["n_slots"],
            max_new_tokens=out["min"], block_size=serve["block_size"],
            prefix_caching=serve["prefix_caching"], temperature=0.0)
        self.executor = LLMExecutor(params(sizes, seed, device), self.cfg,
                                    self.scfg)
        self.engine = CutieEngine("fcfs", clock=time.perf_counter)
        self.engine.register("llm", self.executor)
        # the engine's trace stamps microseconds from its own origin on
        # the same clock: this turns them into time.perf_counter seconds
        trace = self.engine.obs.trace
        self.origin = time.perf_counter() - trace.now_us() / 1e6

    def submit(self, prompt):
        return self.engine.submit(prompt, model="llm")

    def step(self) -> None:
        self.engine.step()

    def idle(self) -> bool:
        return not self.engine.busy()

    def admitted(self, h) -> bool:
        return h.status is not self._queued

    def finished(self, h) -> bool:
        return h.done

    def tokens(self, h):
        """The served tokens of a finished request (None if it failed)."""
        return list(h.request.result) if h.status is self._ok else None

    def spans(self) -> list[tuple]:
        """The engine's own spans as (name, start_s, end_s, args), times
        on time.perf_counter."""
        out, open_ = [], {}
        for ev in self.engine.trace_export()["traceEvents"]:
            key = (ev["name"], ev.get("tid"))
            if ev["ph"] == "B":
                open_[key] = ev
            elif ev["ph"] == "E" and key in open_:
                b = open_.pop(key)
                out.append((ev["name"], self.origin + b["ts"] / 1e6,
                            self.origin + ev["ts"] / 1e6,
                            {**b.get("args", {}), **ev.get("args", {})}))
        return out

    def close(self) -> None:
        self.engine = self.executor = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(sizes: dict, traffic: dict, seed: int, device) -> Server:
    return Server(sizes, traffic, seed, device)
