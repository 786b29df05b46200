"""The port's serving-state snapshot and its three dense config files,
on the CPU at reduced size.

* Within the port: an engine snapshotted mid-decode (some requests
  decoding, some still queued) and restored into a fresh engine finishes
  bit-identically with the uninterrupted one: the same tokens, the same
  logits bits at every sampled step, the same executor stats; with the
  raw and the trit KV codec, paged and contiguous.
* Across packages only the state carries over: a reference snapshot
  restored in the port holds the reference's pages (bytes), positions,
  pending tokens, block tables, pool and prefix cache and queue, and
  then decodes the reference's greedy tokens under the top-2 margin rule
  of `tests/test_torch_llm.py` (``LOGIT_TOL``).
* internlm2-1.8b, codeqwen1.5-7b and qwen2.5-32b: the port's config
  equals the reference's; at their reduced size (2 layers, d_model 64,
  ``ternary_packed``) prefill and decode logits within ``LOGIT_TOL`` of
  the reference's and the same greedy tokens under the margin rule; at
  full size the parameter tree's shapes, dtypes and count equal the
  reference's (``jax.eval_shape`` against the port's init on the meta
  device: nothing is allocated).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import decoding as JDEC
from repro.models import transformer as JTF
from repro.models.config import reduce_for_smoke as jreduce
from repro.serving import CutieEngine as JEngine
from repro.serving import LLMExecutor as JLLM
from repro.serving import ServerConfig as JServerConfig
from repro.serving import save_serving_state as jsave
from repro_torch import configs, convert
from repro_torch.checkpoint.checkpoint import _flatten
from repro_torch.models import common as C
from repro_torch.models import decoding as DEC
from repro_torch.models import transformer as TF
from repro_torch.models.config import reduce_for_smoke
from repro_torch.serving import (CutieEngine, LLMExecutor, RequestStatus,
                                 ServerConfig, restore_serving_state,
                                 save_serving_state)

LOGIT_TOL = 2.0 ** -4          # tests/test_torch_llm.py's bf16 tolerance
BLOCK = 8
OVERRIDES = dict(n_layers=2, quant="ternary_packed", attn_kv_chunk=BLOCK)
_SHARED = list(np.arange(20) % 50)
_PROMPTS = [np.array(_SHARED + [100 + i, i]) for i in range(5)]
_KW = dict(n_slots=2, max_new_tokens=6, max_len=64, block_size=BLOCK)
DENSE = ("internlm2_1_8b", "codeqwen1_5_7b", "qwen2_5_32b")


def _pair(arch="llama3_2_1b", seed=0):
    jcfg = jreduce(jconfigs.get(arch)).replace(**OVERRIDES)
    cfg = reduce_for_smoke(configs.get(arch)).replace(**OVERRIDES)
    jp = JTF.init_params(jcfg, jax.random.PRNGKey(seed))
    p = convert.llm_params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                      device="cpu")
    return jp, jcfg, p, cfg


@pytest.fixture(scope="module")
def llama():
    return _pair()


def _record(ex) -> list:
    """Keep every logits tensor the executor samples from."""
    seen, sample = [], ex._sample

    def sample_(lg):
        seen.append(lg.detach().clone())
        return sample(lg)

    ex._sample = sample_
    return seen


def _engine(p, cfg, **kw):
    eng = CutieEngine("fcfs")
    ex = LLMExecutor(p, cfg, ServerConfig(**_KW, **kw))
    eng.register("llm", ex)
    return eng, ex


@pytest.mark.parametrize("kv", [dict(kv_codec="raw"), dict(kv_codec="trit"),
                                dict(paged=False)],
                         ids=["raw", "trit", "contiguous"])
def test_restore_mid_decode_continues_bit_identically(llama, tmp_path, kv):
    _, _, p, cfg = llama
    ref, rex = _engine(p, cfg, **kv)
    want_logits = _record(rex)
    hs = [ref.submit(pr, model="llm") for pr in _PROMPTS]
    want = ref.run()
    eng, ex = _engine(p, cfg, **kv)
    got_logits = _record(ex)
    for pr in _PROMPTS:
        eng.submit(pr, model="llm")
    for _ in range(3):                           # "kill" mid-decode
        eng.step()
    status = {r.status for r in eng._requests.values()}
    assert {RequestStatus.QUEUED, RequestStatus.RUNNING} <= status
    before = len(got_logits)
    path = save_serving_state(eng, str(tmp_path / "ck"))
    eng2, ex2 = _engine(p, cfg, **kv)
    rest_logits = _record(ex2)
    handles = restore_serving_state(eng2, path.rsplit("/", 1)[0])
    assert sorted(handles) == sorted(
        r.uid for r in eng._requests.values()
        if r.status in (RequestStatus.QUEUED, RequestStatus.RUNNING))
    eng2.run()
    for old_uid, h in handles.items():
        assert h.status is RequestStatus.DONE
        assert h.request.result == want[old_uid]
    assert [h.uid for h in hs] == sorted(want)
    logits = got_logits[:before] + rest_logits
    assert len(logits) == len(want_logits)
    for a, b in zip(logits, want_logits):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert ex2.extra_stats() == rex.extra_stats()
    if kv.get("kv_codec") == "trit":
        assert ex2.kv_store.pages["k"].dtype == torch.uint8


def test_snapshot_holds_the_generator_state(llama, tmp_path):
    """Sampled decoding (temperature > 0) continues bit-identically too:
    the generator's state rides the snapshot."""
    _, _, p, cfg = llama
    ref, _ = _engine(p, cfg, temperature=1.0, seed=5)
    for pr in _PROMPTS[:3]:
        ref.submit(pr, model="llm")
    want = ref.run()
    eng, _ = _engine(p, cfg, temperature=1.0, seed=5)
    for pr in _PROMPTS[:3]:
        eng.submit(pr, model="llm")
    eng.step()
    eng.step()
    save_serving_state(eng, str(tmp_path))
    eng2, _ = _engine(p, cfg, temperature=1.0, seed=99)
    handles = restore_serving_state(eng2, str(tmp_path))
    eng2.run()
    assert {u: h.request.result for u, h in handles.items()} == {
        u: want[u] for u in handles}


def test_restore_requires_matching_models(llama, tmp_path):
    _, _, p, cfg = llama
    eng, _ = _engine(p, cfg)
    eng.submit(_PROMPTS[0], model="llm")
    eng.step()
    save_serving_state(eng, str(tmp_path))
    other = CutieEngine("fcfs")
    other.register("renamed", LLMExecutor(p, cfg, ServerConfig(**_KW)))
    with pytest.raises(ValueError, match="do not match"):
        restore_serving_state(other, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        restore_serving_state(eng, str(tmp_path / "empty"))


def _record_ref_rows(ex) -> dict:
    """Per request uid, the reference's logits row of each emitted token
    (`tests/test_torch_llm.py`'s recorder)."""
    rows: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        lg32 = np.asarray(lg, np.float32)
        if admitting:
            rows.setdefault(admitting.pop(), []).append(lg32[0])
        else:
            for i, r in enumerate(ex.slots):
                if r is not None:
                    rows[r.uid].append(lg32[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return rows


def _margin_equal(got, want, rows, vocab):
    """Greedy tokens equal up to the first step where the reference's
    top-2 margin is within 2 x LOGIT_TOL."""
    assert len(got) == len(want)
    for j, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        top = np.sort(rows[j][:vocab])[-2:]
        assert top[1] - top[0] <= 2 * LOGIT_TOL, (j, a, b)
        return


@pytest.mark.parametrize("kv_codec", ["raw", "trit"])
def test_reference_snapshot_restores_in_the_port(llama, tmp_path, kv_codec):
    jp, jcfg, p, cfg = llama
    kw = dict(_KW, kv_codec=kv_codec)
    jref = JEngine("fcfs")
    jrex = JLLM(jp, jcfg, JServerConfig(**kw))
    rows = _record_ref_rows(jrex)
    jref.register("llm", jrex)
    for pr in _PROMPTS:
        jref.submit(pr, model="llm")
    want = jref.run()
    jeng = JEngine("fcfs")
    jex = JLLM(jp, jcfg, JServerConfig(**kw))
    jeng.register("llm", jex)
    for pr in _PROMPTS:
        jeng.submit(pr, model="llm")
    for _ in range(3):
        jeng.step()
    jsave(jeng, str(tmp_path))
    eng, ex = _engine(p, cfg, kv_codec=kv_codec)
    handles = restore_serving_state(eng, str(tmp_path))
    # the state, as the reference left it
    for name, page in jex.kv_store.pages.items():
        a = np.asarray(page)
        mine = ex.kv_store.pages[name]
        if a.dtype == jnp.bfloat16:
            assert np.array_equal(mine.view(torch.int16).numpy(),
                                  a.view(np.int16)), name
        else:
            assert np.array_equal(mine.numpy(), a), name
    assert ex.pos.tolist() == np.asarray(jex.pos).tolist()
    assert ex.cur_tok[:, 0].tolist() == np.asarray(jex.cur_tok)[:, 0].tolist()
    assert ex.manager.state_dict() == jex.manager.state_dict()
    assert ex.pool.state_dict() == jex.pool.state_dict()
    assert ex.cache.state_dict() == jex.cache.state_dict()
    assert [r.uid if r else None for r in ex.slots] == [
        r.uid if r else None for r in jex.slots]
    queued = sorted(jeng.scheduler._queued.values(), key=lambda r: r.seq)
    assert [h.request.value.tolist() for u, h in sorted(handles.items())
            if u in {r.uid for r in queued}] == [
        np.asarray(r.value).tolist() for r in queued]
    eng.run()
    for uid, h in handles.items():
        assert h.status is RequestStatus.DONE
        _margin_equal(h.request.result, want[uid], rows[uid], cfg.vocab)


# ---------------------------------------------------------------------------
# the three dense config files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_reference_at_reduced_size(arch):
    assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
        jconfigs.get(arch))
    jp, jcfg, p, cfg = _pair(arch, seed=1)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 13))
    jl, jc = JDEC.prefill_with_cache(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                     32)
    tl, tc = DEC.prefill_with_cache(p, {"tokens": torch.as_tensor(toks)},
                                    cfg, 32)
    err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)).max()
    assert err <= LOGIT_TOL, err
    # greedy decode, each package from its own cache and its own tokens
    jt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab], -1))
    tt = tl[:, -1, :cfg.vocab].argmax(-1).numpy()
    pos = 13
    for step in range(4):
        rows = np.asarray(jl[:, -1, :cfg.vocab], np.float32)
        for b in range(2):
            if jt[b] != tt[b]:
                top = np.sort(rows[b])[-2:]
                assert top[1] - top[0] <= 2 * LOGIT_TOL, (arch, step, b)
        jl, jc = JDEC.decode_step(jp, jnp.asarray(jt)[:, None], jc,
                                  jnp.full((2,), pos), jcfg)
        tl, tc = DEC.decode_step(p, torch.as_tensor(tt)[:, None], tc,
                                 torch.full((2,), pos), cfg)
        if np.array_equal(jt, tt):
            err = np.abs(tl.float().numpy() - np.asarray(jl, np.float32)
                         ).max()
            assert err <= LOGIT_TOL, (arch, step, err)
        jt = np.asarray(jnp.argmax(jl[:, -1, :cfg.vocab], -1))
        tt = tl[:, -1, :cfg.vocab].argmax(-1).numpy()
        pos += 1


@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_full_width_parameter_tree(arch, monkeypatch):
    """Every leaf's shape and dtype (the reference's stacked layer axis
    unstacked) and the parameter count at full size, allocating
    nothing."""
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    want = jax.eval_shape(lambda k: JTF.init_params(jcfg, k),
                          jax.random.PRNGKey(0))

    class MetaGen:
        device = torch.device("meta")

    monkeypatch.setattr(C, "_normal", lambda gen, shape: torch.empty(
        tuple(shape), device="meta"))
    got = TF.init_params(cfg, MetaGen())
    assert len(got["layers"]) == cfg.n_layers
    ref, mine = dict(_flatten(want)), dict(_flatten(got))
    n_ref = 0
    for path, leaf in ref.items():
        n_ref += int(np.prod(leaf.shape))
        if path.startswith("layers/"):
            rest = path[len("layers/"):]
            assert leaf.shape[0] == cfg.n_layers, path
            for i in (0, cfg.n_layers - 1):
                t = mine[f"layers/{i}/{rest}"]
                assert tuple(t.shape) == tuple(leaf.shape[1:]), path
                assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        else:
            assert tuple(mine[path].shape) == tuple(leaf.shape), path
    n_mine = sum(t.numel() for t in mine.values())
    assert n_mine == n_ref
    assert len(mine) == (len(ref) - sum(p.startswith("layers/") for p in ref)
                         ) + cfg.n_layers * sum(p.startswith("layers/")
                                                for p in ref)
