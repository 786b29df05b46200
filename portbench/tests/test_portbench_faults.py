"""A run with the timed path broken underneath reads `correct` false:
once for each fault the cells can have (an answer or a token altered
where it is produced; half of the batch left out).  The harness's look
for a card is skipped: the shrunk cells run on the CPU."""

import pytest
import torch

from portbench.tests import test_portbench_tiny as tiny


def _run(name, fault):
    return tiny.run(name, 21, fault=fault)


class _Wrap:
    def __init__(self, program, edit):
        self.program, self.edit, self.calls = program, edit, 0

    def __call__(self, images):
        y = self.program(images).clone()
        self.calls += 1
        return self.edit(y, self.calls)


def _one_answer_altered(y, n):
    if n == 7:                       # one trit of one image of one call
        y[3, 2] = 1 if y[3, 2] != 1 else -1
    return y


def _half_left_out(y, n):
    y[y.shape[0] // 2:] = 0
    return y


@pytest.mark.parametrize("edit", [_one_answer_altered, _half_left_out])
def test_cnn_fault_reads_not_correct(edit):
    r = _run("cifar10-bulk", lambda p: _Wrap(p, edit))
    assert r["correct"] is False
    assert r["compared"]["mismatched_images"]["value"] >= 1


def _token_altered(server):
    ex, sample = server.executor, server.executor._sample
    seen = [0]

    def sample_(lg):
        seen[0] += 1
        tok = sample(lg)
        if seen[0] % 3 == 0:         # the least likely token, now and then
            tok = lg[:, :ex.cfg.vocab].argmin(dim=-1)
        return tok

    ex._sample = sample_
    return server


def _half_batch_left_out(server):
    ex, sample = server.executor, server.executor._sample

    def sample_(lg):
        tok = sample(lg)
        if lg.shape[0] > 1:          # a decode step: odd slots not computed
            tok = tok.clone()
            tok[1::2] = lg[1::2, :ex.cfg.vocab].argmin(dim=-1)
        return tok

    ex._sample = sample_
    return server


@pytest.mark.parametrize("fault", [_token_altered, _half_batch_left_out])
def test_decoder_fault_reads_not_correct(fault):
    r = _run("llava-docs", fault)
    assert r["correct"] is False
    gap = r["compared"]["max_gap"]
    assert gap["value"] > gap["limit"]


def test_the_sound_runs_read_correct():
    for name in ("cifar10-bulk", "llava-docs"):
        assert _run(name, None)["correct"] is True
    assert torch.get_default_dtype() == torch.float32
