"""The one traffic generator: the same seed gives the same inputs, and
every seed the same sizes and think times, in an order of its own."""

import numpy as np
import pytest
import torch

from portbench import traffic as TR

DOCS = {"block": 16, "prompt_tokens": {"dist": "log_uniform", "min": 256,
                                       "max": 1024},
        "output_tokens": {"dist": "fixed", "min": 8, "max": 8},
        "think_s": {"dist": "exponential", "mean": 0.5}}
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_requests_repeat_for_one_seed(seed):
    a = TR.requests(DOCS, 32000, seed, 40)
    b = TR.requests(DOCS, 32000, seed, 40)
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


def test_requests_differ_between_seeds_but_not_in_sizes():
    a = TR.requests(DOCS, 32000, 1, 64)
    b = TR.requests(DOCS, 32000, BIG, 64)
    assert not any(np.array_equal(x["prompt"], y["prompt"])
                   for x, y in zip(a, b))
    want = sorted(TR.stratified_lengths(DOCS["prompt_tokens"], 16))
    thinks = sorted(TR.stratified(DOCS["think_s"], 16))
    for blk in range(4):
        for reqs in (a, b):
            part = reqs[16 * blk:16 * blk + 16]
            assert sorted(len(r["prompt"]) for r in part) == want
            assert sorted(r["think_s"] for r in part) == thinks
    assert len({len(r["prompt"]) for r in a[:16]}) == 16
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]
    assert [r["think_s"] for r in a] != [r["think_s"] for r in b]
    assert {r["new_tokens"] for r in a} == {8}


def test_think_times_are_exponential_strata():
    t = TR.stratified(DOCS["think_s"], 16)
    assert np.all(np.diff(t) > 0) and t.min() > 0
    assert abs(t.mean() - 0.5) < 0.05
    bare = {k: v for k, v in DOCS.items() if k != "think_s"}
    assert TR.requests(bare, 32000, 1, 4)[0]["think_s"] == 0.0


def test_a_longer_draw_extends_a_shorter_one():
    a = TR.requests(DOCS, 32000, 5, 32)
    b = TR.requests(DOCS, 32000, 5, 96)
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))


def test_stratified_lengths_stay_in_range_and_spread():
    n = TR.stratified_lengths(DOCS["prompt_tokens"], 16)
    assert n.min() >= 256 and n.max() <= 1024 and len(set(n)) == 16
    assert np.all(np.diff(n) > 0)


def test_image_pool_repeats_for_one_seed_only():
    traffic, sizes = {"pool_images": 4}, {"img_hw": 8, "img_channels": 3}
    a = TR.image_pool(traffic, sizes, BIG, "cpu")
    assert torch.equal(a, TR.image_pool(traffic, sizes, BIG, "cpu"))
    assert not torch.equal(a, TR.image_pool(traffic, sizes, BIG + 1, "cpu"))
    assert a.shape == (4, 8, 8, 3) and 0 <= a.min() and a.max() < 1


def test_warmup_prompts_share_no_block_with_timed_ones():
    lens = TR.stratified_lengths(DOCS["prompt_tokens"], 16)
    warm = TR.warmup_prompts(DOCS, 32000, 3, lens)
    timed = TR.requests(DOCS, 32000, 3, 16)
    firsts = {tuple(r["prompt"][:16]) for r in timed}
    assert not any(tuple(p[:16]) in firsts for p in warm)
