"""One run of each cell, shrunk, on the CPU: the result line's fixed keys
and the numbers compared."""

import json

import pytest

from portbench import harness
from portbench.tests import test_portbench_tiny as tiny

CELLS = tiny.CELLS


def _run(name, seed=9, **kw):
    return tiny.run(name, seed, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_fixed_keys(name):
    r = _run(name)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "compared" and "breakdown" not in r
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = harness.cell(tiny.manifest(), name)
    want = {m["name"]: m["unit"] for m in cell["end_to_end"]}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for k, v in r["compared"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    line = json.dumps(harness.finite(r))
    assert json.loads(line)["correct"] is True
    assert all(s.startswith("compared ")
               for s in harness.compared_lines(r))


def test_infinity_prints_as_null():
    assert harness.finite({"a": [float("inf"), 1.0]}) == {"a": [None, 1.0]}


@pytest.mark.parametrize("metric", ["prefill_us_per_token.llm",
                                    "decode_step_ms.llm"])
def test_program_span_metrics_read_the_untraced_part_only(metric):
    spans = [("prefill", 1.0, 1.5, {"computed": 100}),
             ("decode", 1.5, 1.6, {"live": 1}),
             ("prefill", 12.0, 12.2, {"computed": 400}),
             ("decode", 12.2, 12.25, {"live": 2}),
             ("decode", 12.3, 12.35, {"live": 2})]
    run = {"window": {"t_start": 0.0, "t_end": 50.0}, "t_untraced": 10.0,
           "program_spans": spans}
    read = harness.load_module(harness.HERE / "metrics" / f"{metric}.py").read
    want = {"prefill_us_per_token.llm": 500.0, "decode_step_ms.llm": 50.0}
    assert read(run) == pytest.approx(want[metric])
    assert read({**run, "t_untraced": 13.0}) is None
