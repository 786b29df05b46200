"""Cells shrunk for the CPU, and the one way the tests run them.  The
shapes keep every kind of layer of the cell (thermometer input, max and
avg pools and a head; GQA attention, SwiGLU, paged KV with several blocks
a sequence).

The decoder cell `llava-docs` is out of BENCHMARK.json: the port's
RMSNorm takes eps 1e-6 where the published configuration states 1e-5,
and has no option to take it (PERF.md, Open questions).  Its files stay
under portbench/, and the tests drive them through the entries below."""

import time

import pytest

from portbench import harness
from portbench import traffic as TR

ROOT = harness.HERE.parent

DECODER = {
    "configs": [{"name": "llava-next-mistral-7b",
                 "source": "https://huggingface.co/llava-hf/"
                           "llava-v1.6-mistral-7b-hf",
                 "file": "portbench/configs/llava-next-mistral-7b.json",
                 "reduced": [], "why": "Mistral-7B text model of LLaVA-NeXT"}],
    "workloads": [{"name": "llava-docs", "config": "llava-next-mistral-7b",
                   "traffic": "docs-closed-8", "chips": 1,
                   "why": "document extraction"}],
    "end_to_end": [
        {"name": "ttft_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": ["llava-docs"]},
        {"name": "tokens_per_s", "unit": "tokens/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": ["llava-docs"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
         "moves": mv, "workloads": ["llava-docs"]}
        for n, u, b, src, layer, mv in [
            ("device_idle.llm", "%", "lower", "device_trace",
             "device (H100)", "ttft_p90_ms"),
            ("k7_roofline.llm", "%", "higher", "device_trace",
             "kernels (src/repro_torch/csrc)", "ttft_p90_ms"),
            ("mfu.llm", "%", "higher", "device_trace", "model (the compiled "
             "CNN program or the decoder forward, whole)", "ttft_p90_ms"),
            ("prefill_us_per_token.llm", "us", "lower", "program_span",
             "serving executor (serving/llm.py LLMExecutor under "
             "serving/engine.py)", "ttft_p90_ms"),
            ("decode_step_ms.llm", "ms", "lower", "program_span",
             "serving executor (serving/llm.py LLMExecutor under "
             "serving/engine.py)", "tokens_per_s")]]}


def manifest():
    """BENCHMARK.json with the decoder cell's entries added."""
    man = harness.manifest(ROOT)
    return {k: v + DECODER[k] if k in DECODER else v for k, v in man.items()}


#: every cell the tests drive
CELLS = [w["name"] for w in manifest()["workloads"]]

SIZES = {
    "cifar10-bulk": {"img_hw": 8, "thermometer_m": 4, "in_channels": 12,
                     "width": 8, "pools": [None, ["max", 2], ["avg", 4]]},
    "llava-docs": {"hidden_size": 64, "num_hidden_layers": 2,
                   "num_attention_heads": 4, "num_key_value_heads": 2,
                   "head_dim": 16, "intermediate_size": 128,
                   "vocab_size": 256,
                   "serve": {"n_slots": 4, "max_len": 64, "block_size": 16,
                             "prefix_caching": True}},
}

#: a window long enough for several requests of the shrunk decoder to
#: finish on a loaded CPU
SECONDS = 4.0

# The shrunk decoder's clients think about two engine steps on average,
# as the full cell's do (a step takes about 10 ms here, 250 ms on the
# card).

TRAFFIC = {
    "cifar10-bulk": {"pool_images": 64, "batch": 16},
    "llava-docs": {"clients": 4, "check_requests": 6,
                   "prompt_tokens": {"dist": "log_uniform", "min": 8,
                                     "max": 40},
                   "output_tokens": {"dist": "fixed", "min": 4, "max": 4},
                   "think_s": {"dist": "exponential", "mean": 0.02}},
}


def shrunk(name):
    """(cell, sizes, traffic) of cell ``name``, shrunk."""
    c = harness.cell(manifest(), name)
    return (c, {**TR.load(c["files"]["sizes"]), **SIZES[name]},
            {**TR.load(c["files"]["traffic"]), **TRAFFIC[name]})


def run(name, seed, **kw):
    """One run of cell ``name``, shrunk, on the CPU."""
    c, sizes, traf = shrunk(name)
    return harness.run_at(c, sizes, traf, seed, SECONDS, False, "cpu",
                          t_process=time.perf_counter(), **kw)


@pytest.mark.parametrize("name", CELLS)
def test_shrinking_changes_only_keys_the_cell_has(name):
    c = harness.cell(manifest(), name)
    assert set(SIZES[name]) <= set(TR.load(c["files"]["sizes"]))
    assert set(TRAFFIC[name]) <= set(TR.load(c["files"]["traffic"]))
