#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one card and check it.

    python3 chip_smoke.py

Phases, each of which fails the script (no result line) when it fails:

1. the card's name and power limit, from nvidia-smi;
2. build every kernel from `src/repro_torch/csrc/` with nvcc (sm_90a),
   printing ptxas's registers and spills per entry function and, for each
   CIFAR layer, the conv kernels' plan (tile, Cout slice, pipelines, grid,
   shared memory), then the trunk kernel's plan of the CIFAR trunk (its
   block size, shared memory and grid, and each layer's tile, slice,
   blocks per slice and patch-copy path);
3. hold each kernel against its plain PyTorch version on the card: the
   conv kernels on the full-width CIFAR layer shapes plus odd-channel,
   stride-2/3, unpadded, raw-int32 and const-channel cases and the edges
   of their planner (`conv_cases`);
   the trunk megakernel on the full CIFAR trunk at batch 64, its two-trunk
   split through a packed boundary and the edges of its planner
   (`trunk_cases`: C = 13 behind a head Cin of 6, stride 2 + avg pool,
   avg 4 on 4 x 4 into a 1 x 1 layer, N = 1, 16 layers, a 1 x 1 trunk);
   kernels 1-3 past the old int16 limit of their avg pools (`WIDE_CONV`:
   avg 6 on 12 x 12, avg 8 on 8 x 8, 128 channels, planned wide); the
   conv shapes of compiled programs (`COMPILED_CONV`: 1 x 1 convs, the
   lowered dense heads, residual widths, pad_to); the codec kernels at
   the main path's shapes, at lengths that are not a multiple of 5, on
   flat and unaligned views, and the codec's KV store forms at the trit
   serve's shapes (bf16 bit for bit); the thermometer kernel in its
   levels and image forms (`thermometer_cases`: every m from 1 to 17 and
   42, ties, out-of-range values, +-inf and NaN, odd lengths, unaligned
   views);
   counters included; the packed ternary matmul (every epilogue, int8 and
   bf16 x, M in {1, 4, 37, 128}, ragged N, a logical K that is not a
   multiple of 5, and the seven llama3.2-1B projections at M = 4 and 64)
   and the dense int8 matmul: int8 x bit for bit, bf16 x within the
   tolerances stated below; then kernel 7's rows at M = 4, 16 and 64
   against the same rows at M = 128, bit for bit (bf16 and int8 x, the
   seven llama projections);
4. the main path: the paper's CIFAR-10 network (Table III, full width:
   126 -> 128 channels, 32 x 32, 8 layers, max-pools after layers 2, 4, 6
   and avg-pool 4 after layer 7; `repro_torch.configs.cutie_cnn`) built
   as a `compiler.Graph` from seeded float weights and BN.  Compiled by
   `CutiePipeline.compile` without its head and unoptimized, it must
   equal the program built layer by layer with `engine.compile_layer`,
   array for array; compiled with the dense 128 -> 10 head and
   optimize=True (its cost table printed, and equal array for array to
   the same graph compiled with ``device="cpu"``), with its batch-64 input
   encoded by one launch of the thermometer kernel's image form, it runs
   through `run`, a traced run and `measure` on the ``cuda``, ``packed``
   and ``fused`` backends and on ``fused`` with an L2 budget that splits
   the trunk in two, joined by packed bytes; outputs, tracer rows and
   energy rows must equal the ``ref`` backend's on the same card, and per
   step each conv kernel's launch count must grow by one per layer, the
   trunk kernel's by one per fused segment (with one conv launch per
   layer of the per-layer segments, the head's), as `execution_plan`
   reports them; then the codec entry points pack and unpack the split's
   boundary trits, which must equal the trunk kernel's own packed bytes.
   The compiled residual and pad_to programs of
   benchmarks/backend_parity.py and tests/test_compiler.py's
   nonconforming graph follow on every backend, held the same way.
   Then the CNN mesh (`mesh_path`): the same program and input, and a
   full-width uniform trunk (8 seeded layers 128 -> 128 at 32 x 32, batch
   64), through `CutiePipeline(mesh=)` in ranks this script starts as
   processes of its own (``--mesh-rank``): ``data:1`` in a world of 1 on
   NCCL, then ``data:2,filter:2``, ``filter:4`` and (the trunk)
   ``layer:4`` with 8 microbatches in a world of 4 on gloo, every rank on
   the one card and the packed bytes staged through the host; on
   ``cuda`` and ``packed``, packed and dense wires.  Every rank's output
   must equal the unmeshed run on its backend bit for bit, and its
   launches of kernels 1/2, 4 and 5 must follow `mesh_launches`; each
   case's collective bytes (dense, packed) and run ms (ranks sharing
   one card: no scaling figure) are printed.
   Then the second main path, LLM serving: llama3.2-1B at full width and
   depth with ``quant="ternary_packed"``, seeded random weights on the
   card, 8 requests of 40 tokens (a shared 32-token prefix + 8 distinct)
   through `CutieEngine` + `LLMExecutor` with the default `ServerConfig`
   (paged, 4 slots, max_len 256, block 16, greedy), 16 new tokens each:
   every request must return 16 tokens, the prefix cache must hit, the
   packed matmul kernel must launch 7 x 16 times per model forward
   (prefill or decode step), the same requests served contiguous must give
   the same tokens, and one prefill's logits with the plain matmul must
   agree with the kernel's within ``LOGIT_TOL``; then the same requests
   with ``kv_codec="trit"`` (kernels 4 and 5 in their KV forms, one launch
   per K or V write and gather) must give the same tokens as with the
   codec's plain versions, and their agreement with the raw serve is
   reported.
   Then the restart path (`restart_path`): the same requests with
   ``kv_codec="trit"``, paged, served for ``RESTART_STEPS`` engine steps
   (4 requests decoding, 4 queued), snapshotted by `save_serving_state`
   and restored by this script in a fresh process (``--restore DIR``),
   which finishes the serve: every token, the bits of every sampled
   logits tensor and the executor's stats must equal an uninterrupted
   serve's, and the restored serve must launch kernels 4, 5 and 7; the
   snapshot's and the restore's wall time, bytes on disk and codec
   launches are printed.
   Then speculative decoding (`spec_path`): the same target and requests
   through `SpecExecutor` with three drafts (the target's first 2 layers
   sharing its embedding and head, the target itself, a random 2-layer
   llama3.2-1B), then the truncated draft with ``kv_codec="trit"`` and at
   temperature 0.8: greedy tokens must follow the plain serve's under the
   top-2 margin rule, a self-draft rejection must sit at a near tie,
   kernel 7 must launch 7 x (16 x target forwards + draft layers x draft
   steps) times and kernels 4 and 5 only in the trit run; tokens/s,
   tokens per verify, acceptance, k and the propose and verify medians
   are printed.  Then the LLM training path (`llm_train_path`):
   full-width llama3.2-1B QAT (``quant="ternary"``, batch 8, seq 128, 6
   steps) through `python -m repro_torch.launch.train`, in this process
   and then in subprocesses checkpointed every 3 steps and preempted at
   step 4, then resumed: the loss finite, the ternarized projections
   alpha times trits, the resumed losses within ``TRAIN_RESUME_ATOL`` of
   the uninterrupted run's; step ms, the forward + backward share,
   launches per step, peak memory and the loss history are printed.
   Then the LLM model mesh (`model_mesh_path`; ranks started as
   ``--model-mesh-rank`` processes, world 1 on NCCL, world 4 on gloo
   with every rank on the one card): the llama3.2-1B decode cell
   (`steps.make_prefill_step`, `prefill_with_cache` and 8 steps of
   `steps.build_cell`'s decode step, the KV cache's sequence over
   ``model``) bit for bit on ``data:1,model:1`` and within
   MODEL_MESH_ULPS on ``data:2,model:2`` and ``model:4``, kernel 7 7 x 16
   per forward per rank; a 4-layer QAT train cell on ``data:2,model:2``
   against the unmeshed steps, its checkpoint restored onto ``model:4``
   and ``data:4`` bit for bit; a full-width qwen3-moe layer with
   ``moe_impl="ep"`` on ``model:4`` against the dense dispatch; ms per
   step (slowest rank's median) and collective bytes per rank printed;
   on ``model:4`` one more decode step walked (`roofline.hlo.walk`)
   beside the dry run's walk of the same cell on ``meta`` tensors
   (`launch.dryrun.local_args` on a `StandInMesh`): exchanges equal op
   for op, argument bytes equal the rank's local bytes.
   Then GPipe and the ssm, hybrid and encdec families on a model axis
   (`gpipe_tp_path`; ``--gpipe-tp-rank`` processes, world 1 on NCCL,
   worlds 2 and 4 on gloo): `launch.pipeline.pipeline_forward_loss` of
   the main path's llama3.2-1B weights (full width and depth, 8 layers a
   stage, batch 8 x seq 128, 4 microbatches) on ``pod:2`` and
   ``pod:2,model:2``, its loss and the last stage's final hidden rows
   against the unmeshed `forward_loss`'s (bit for bit on ``pod:2``), its
   collective-permutes against the dry run's prediction record for
   record; mamba2-780m (8 of 48 layers, batch 8) on ``data:1,model:1``
   (bit for bit) and ``model:2``, zamba2-2.7b (one attn_every period) on
   ``model:2`` and ``model:4``, whisper-medium (4 + 4 layers, 1 x 1500
   frames, the cross cache split over ``model``) on ``model:2``, each a
   prefill step and a prompt + 4 decode steps of `steps.build_cell`
   against the unmeshed run and the unmeshed run with the row-cut
   projections' bf16 partial sums (`row_partials`) within the cell's
   FAMILY_MESH_ULPS; kernel 7 per sliced shape against its plain
   version in every cell.
   Then the moe and ssm families (`moe_path`, `ssm_path`): full-width
   deepseek-moe-16b (all 28 layers; seeded weights, routed experts
   dense bf16) and mamba2-780m
   (``SSM_PATH_LAYERS`` of its 48 layers), ``ternary_packed``, serve the
   same requests: kernel 7 launches 4 x layers + 3 + 3 x (layers - 1)
   per deepseek forward and 3 x layers per mamba2 token step;
   paged and contiguous tokens identical; a second deepseek serve
   bit-identical in tokens and logits; deepseek's plain-matmul prefill
   held layer by layer and end to end (`moe_plain_prefill_check`), its
   trit-KV serve against the plain codec, its route histogram and
   dropped assignments printed; mamba2's mixers with kernel 7 against
   the plain matmul on the same inputs and states, at M = 1 and 4
   (`ssm_plain_check`), its chunked forward over 5 chunks against its
   recurrence (`ssm_chunked_check`), a mid-decode `snapshot`/`restore`
   in process, a speculative serve of the 8 requests in two waves with
   a 2-layer truncated draft under the margin rule and the trit
   `StatePagedStore` on the card; each
   with its serving times and device busy share.
   Then the hybrid, encdec and vlm families, full width (and depth but
   zamba2's, cut to ``HYBRID_PATH_LAYERS`` of 54),
   ``ternary_packed``, seeded weights (`hybrid_path`, `encdec_path`,
   `vlm_path`): zamba2-2.7b runs 4 of the requests' prompts through
   `ssm_prefill` and 16 greedy decode steps (kernel 7 3 x 18 + 7 x 3 =
   75 per token step; the 3 applications of the shared block read one
   weight set and write 3 distinct KV caches; every kernel-7 call of a
   decode step and every mixer call of a prefill against the plain
   matmul on the same input; the chunked forward against the recurrence
   layer by layer, the shared block included); whisper-medium encodes 2 x
   1500 seeded frames (144 launches at M = 3000), fills the cross cache
   from `_xattn_kv` (48), runs an 8-token prompt teacher-forced through
   `decode_step` (192 per step; its last logits against `forward_logits`)
   and 16 greedy steps, each encoder and decoder layer and each of their
   projections against the plain matmul on the kernel run's input;
   llava-next-mistral-7b serves the 8 requests through `LLMExecutor`
   (224 per forward, paged == contiguous, `plain_prefill_check`) and runs
   `forward_loss` over 576 seeded patches and 64 tokens against the plain
   matmul; kernel 7 at M = 3000 and 640 is timed against the library call
   with its split-K workspace per call; each path with its parameter
   bytes, host medians, the device's busy share of a profiled run and its
   peak memory.
   Then the third main path, train -> compile -> serve (`cnn_main_path`):
   `train.cutie_qat.run` trains the full-width CIFAR-10 QAT network
   (width 128, thermometer m 42, batch 64) for ``QAT_STEPS`` steps of INQ
   Magnitude-Inverse on synthcifar, every batch encoded by kernel 6 (the
   loss must be finite and fall; after the final freeze every effective
   weight must be a trit), one training step at a reduced width is held
   against the port's CPU step (TF32 off); `cutie_qat.compile` compiles
   the result with its head (optimize=True) on the card, which must equal
   its compile on the CPU array for array and ``ref`` on
   ``cuda``, ``packed``, ``fused`` and a two-trunk ``fused`` split (with
   the codec entry points on the split's boundary), and the QAT graph's
   argmax must agree with the pipeline's on at least ``AGREE_FLOOR`` of
   the test images; then `CutieEngine` + `ProgramExecutor` serve it on
   ``cuda`` (SwitchingTracer) and ``fused`` with buckets (1, 2, 4, 8),
   after every bucket alone on every backend has equalled ``ref``:
   an open-loop Poisson trace at 3x the calibrated capacity, 25%
   tight-deadline traffic, under ``fcfs`` and ``deadline`` (every
   response equal to ``ref``'s, program variants within the buckets),
   then `benchmarks/fault_injection.py`'s chaos and shed scenarios over a
   `FaultyExecutor`; the trained params, INQ state and compiled
   program go through `checkpoint.save` / `restore` on the card (the
   program's int8 trit leaves packed by kernel 4 and unpacked by kernel 5,
   one launch each), and the restored params must compile to the same
   program; every kernel of the path must have launched;
5. time the whole program (`run`, `measure`) per backend on the host
   clock, then each kernel at the main path's shapes beside its bound, its
   plain version and, where one PyTorch call computes the same function,
   that call as a library yardstick (f16 channels-last `F.conv2d`, whose
   int32 cast must equal the conv kernel's raw output, with f32
   `F.conv2d` beside it; bf16 `torch.matmul` on pre-decoded weights;
   `torch._int_mm`); every kernel also with its device-only time and, for
   1, 2, 3, 7 and 8, the library call's (torch.profiler); kernel 3 with its
   per-layer timeline (the kernel's own clock stamps); kernels 3-8
   with the wrapper's host microseconds per call, kernel 7 at the decode M
   and at the prefill M; kernel 6 in its image form (as the main path
   calls it) and levels form beside the former chain (the four eager
   passes of the quantizer, then the levels form) and its wrapper's host
   split; kernels 4 and 5 in their KV forms at the trit
   serve's shapes beside the store's former chain of kernel and torch
   ops; then the serving times
   (decode step, prefill, tokens/s, latency p50/p99) of the LLM path and
   of the same requests on ``quant="none"``, the bf16 baseline, and the
   trit serve with the former chain and with the KV forms (decode
   medians, device busy under torch.profiler); and for the CNN path a
   full-width QAT step (with its forward + backward share), an evaluation
   batch, the serves' images/s and latency percentiles per scheduler and
   tag, one engine step per bucket, and the device's busy share of a
   closed-loop serve under torch.profiler.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero without a card, and
when run outside a checkout of the repository.  The script runs itself
again under ``PYTHONHASHSEED=0`` (synthcifar's samples are seeded with
``hash(split)``) unless it already runs under that salt.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
BATCH = 64
SEED = 0
SOURCE = {
    "ternary_conv2d": "src/repro_torch/csrc/ternary_conv2d.cu",
    "ternary_conv2d_packed": "src/repro_torch/csrc/ternary_conv2d.cu",
    "fused_trunk": "src/repro_torch/csrc/fused_trunk.cu",
    "pack_trits": "src/repro_torch/csrc/trit_codec.cu",
    "unpack_trits": "src/repro_torch/csrc/trit_codec.cu",
    "thermometer": "src/repro_torch/csrc/trit_codec.cu",
    "ternary_matmul": "src/repro_torch/csrc/ternary_matmul.cu",
    "ternary_matmul_dense": "src/repro_torch/csrc/ternary_matmul.cu",
}
REPLACES = {
    "ternary_conv2d": "src/repro/kernels/ternary_conv2d.py:223",
    "ternary_conv2d_packed": "src/repro/kernels/ternary_conv2d.py:281",
    "fused_trunk": "src/repro/kernels/fused_trunk.py:172",
    "pack_trits": "src/repro/kernels/trit_codec.py:65",
    "unpack_trits": "src/repro/kernels/trit_codec.py:86",
    "thermometer": "src/repro/kernels/trit_codec.py:116",
    "ternary_matmul": "src/repro/kernels/ternary_matmul.py:90",
    "ternary_matmul_dense": "src/repro/kernels/ternary_matmul.py:159",
}
# the conv kernels' library_ms; library_f32_ms is f32 F.conv2d, TF32 off
LIBRARY_CONV = "F.conv2d f16 channels-last, 8 calls (exact integers)"
SPLIT_AT = 4                       # the two-trunk split: layers [0, 4), [4, 8)
sys.path.insert(0, os.path.join(ROOT, "src"))
from repro_torch.configs.cutie_cnn import CONFIG as CIFAR  # noqa: E402
from repro_torch.roofline import terms as RT  # noqa: E402

# the bounds' rates: one H100 SXM (`repro_torch.roofline.terms`)
HBM_BYTES_PER_S = RT.HBM_BW         # device memory
INT8_OPS_PER_S = RT.PEAK_INT8_OPS   # dense int8 tensor-core peak
BF16_OPS_PER_S = RT.PEAK_FLOPS      # dense bf16 tensor-core peak

# paper Table III: the merged pool of each conv layer, and the widths
CIFAR_POOLS = tuple(pool for _op, _mult, pool in CIFAR.layout)
CIFAR_CIN, CIFAR_WIDTH, CIFAR_HW, THERMO_M = (
    CIFAR.in_channels, CIFAR.width, CIFAR.img_hw, CIFAR.thermometer_m)
# the compiled network's layer FIFO holds the dense head too, as the
# reference's train.cutie_qat.compile(include_head=True) sizes it
CIFAR_DEPTH = len(CIFAR.layout) + 1
# the LLM path: llama3.2-1B at full width and depth, ternary_packed, served
# with the default ServerConfig (paged, 4 slots, max_len 256, block 16)
LLM_ARCH, LLM_REQUESTS, LLM_PREFIX, LLM_PROMPT, LLM_NEW = (
    "llama3.2-1b", 8, 32, 40, 16)
# rows of one decode step's K (or V) gather through the block tables in the
# trit serve: 16 layers x 4 slots x 16 blocks x 16 positions x 8 KV heads
KV_ROWS = 16 * 4 * 16 * 16 * 8
KV_WRITE_ROWS = 16 * 4 * 8           # one decode step's K (or V) write
DECODE_M, PREFILL_M = 4, 64        # n_slots; bucket of a 40-token prompt
INVARIANT_M = (4, 16, 64)          # decode, prefix-hit and cold prefill M
# (name, K, N) of one layer's seven packed projections
LLM_PROJ = (("q", 2048, 2048), ("k", 2048, 512), ("v", 2048, 512),
            ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
            ("down", 8192, 2048))
# Tolerances for float x (int8 x must be bit-identical): the kernel sums
# the same exact f32 products as the plain version in another order, so a
# bf16 output may round one ulp apart (2**-7 of the output's largest
# magnitude), an f16 output one f16 ulp (2**-10 of it) and an f32 output
# within 1e-5 of it.  Whole-model logits of one prefill (16 layers, each
# rounding its activations to bf16) within LOGIT_TOL absolute.
BF16_OUT_TOL, F32_OUT_TOL, LOGIT_TOL = 2.0 ** -7, 1e-5, 0.125
F16_OUT_TOL = 2.0 ** -10
# the CNN train -> compile -> serve path: full-width QAT (batch 64) for
# QAT_STEPS steps, QAT_EVAL_N test images; a training step checked card
# vs CPU at STEP_CHECK_WIDTH (TF32 off): loss within STEP_LOSS_RTOL, grad
# norm within STEP_GN_RTOL, updated tensors within STEP_ATOL except where
# a gradient's sign flipped (at most STEP_FLIP_SHARE of the values, each
# within the step's bound 2 * lr); QAT-vs-pipeline argmax agreement at
# least AGREE_FLOOR (tests/test_engine.py's floor); then a serve with
# benchmarks/serving_load.py's parameters: SERVE_REQUESTS open-loop
# Poisson arrivals per scheduler at OVERLOAD x the calibrated capacity,
# INTERACTIVE_FRAC with a deadline of TARGET_MULT full-batch steps, the
# rest BATCH_DEADLINE_MULT, images drawn from a pool of SERVE_POOL
QAT_STEPS, QAT_EVAL_N, STEP_CHECK_WIDTH = 80, 256, 16
STEP_LOSS_RTOL, STEP_GN_RTOL, STEP_ATOL, STEP_FLIP_SHARE = (
    1e-5, 1e-4, 1e-5, 1e-3)
AGREE_FLOOR = 0.75
# the restart path: engine steps served before the snapshot (4 requests
# resident and decoding, 4 queued); the hash salt the script runs under
RESTART_STEPS = 6
HASH_SEED = "0"
# speculative decoding: the margin rule of tests/test_torch_llm.py (a spec
# token may differ from the plain serve's only where the plain top-2 logit
# margin is at most 2 x SPEC_LOGIT_TOL); the truncated and random drafts'
# depth
SPEC_LOGIT_TOL, SPEC_DRAFT_LAYERS = 2.0 ** -4, 2
# a self-draft's decode-step rows against the verify's suffix-forward rows
# of the same positions, and the plain serve's decode rows against one
# forward over the same tokens, at full width: 16 layers round their
# activations to bf16 along two paths that differ in attention and in the
# head matmul's algorithm.  On an H100 80GB HBM3 at 700 W (max |logit|
# about 5, a bf16 ulp 2**-5 there): reordering only kernel 7's f32 sums
# moves the full-width prefill's logits by 0.0625, the plain serve's
# decode rows differ from one forward over the same tokens by up to
# 0.0625, and the self-draft's rows by up to 0.078125 (half of them past
# 2**-4).  The reduced CPU tests hold 2**-4; the card holds these rows
# within the next power of two.
SPEC_ROW_TOL = 2.0 ** -3
# the LLM training path: full-width llama3.2-1B QAT through launch.train,
# checkpointed every TRAIN_CKPT_EVERY steps and preempted at TRAIN_FAIL_AT;
# the resumed run's losses within TRAIN_RESUME_ATOL of the uninterrupted
# run's (eager CUDA backward ops such as the embedding's index_add sum with
# atomics, so two runs are not bit-identical on the card)
TRAIN_STEPS, TRAIN_SEQ, TRAIN_BATCH = 6, 128, 8
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT, TRAIN_RESUME_ATOL = 3, 4, 2.0 ** -4
# the INQ check's steps: the paper's schedule compressed into two freezes
TRAIN_INQ_STEPS = 2
# the moe and ssm paths: deepseek-moe-16b and mamba2-780m at full width and
# depth, ternary_packed, serving the LLM path's requests with its
# ServerConfig.  deepseek's prefill with the plain matmul: each layer on
# the kernel run's input and routes, its increment (output minus input)
# within MOE_LAYER_ULPS bf16 ulps of the position's largest |increment|
# (each projection rounds its bf16 output at most one or two ulps apart);
# the logits, routed as the kernel's, within MOE_LOGIT_TOL.  Seeded
# deepseek weights (experts drawn with fan-in E, as the reference's init)
# carry a residual stream of |h| up to about 1,100 by layer 27, and a
# position's rounding differences grow from layer to layer: on an H100
# 80GB HBM3 at 700 W the logits of positions 0-22 of the main path's
# first prompt stayed within 0.03, positions 23-39 reached 0.30-0.51 (max
# |logit| 4.97), while every layer's increment stayed within 0.5 ulp.
# mamba2's mixers with the plain matmul, each on the
# kernel run's input and state: output within SSM_MIXER_ULPS bf16 ulps of
# the position's largest |output|, over the first prompt at M = 1 and
# SSM_CHECK_STEPS steps at M = 4.  mamba2's chunked forward (chunk
# SSM_CHECK_CHUNK, 5 chunks of the 40-token prompt) against its
# token-by-token recurrence: each layer on the same input within
# SSM_LAYER_RTOL of its largest |output|; end to end a correlation above
# SSM_CORR and the step's argmax among the forward's top 5 (48 seeded
# layers compound the bf16 differences of the two paths).  On the same
# card: every mixer within 0.5 ulp; the chunked forward per layer within
# 0.0316 of its largest output, correlation 0.949.  The ssm path's
# speculative draft depth
MOE_ARCH, SSM_ARCH = "deepseek-moe-16b", "mamba2-780m"
MOE_LAYER_ULPS, MOE_LOGIT_TOL = 4, 1.0
SSM_MIXER_ULPS, SSM_CHECK_STEPS, SSM_CHECK_CHUNK = 4, 8, 8
SSM_LAYER_RTOL, SSM_CORR, SSM_DRAFT_LAYERS = 2.0 ** -4, 0.9, 2
# the hybrid, encdec and vlm paths, each at full width and depth,
# ternary_packed, seeded weights.  zamba2-2.7b: the first HYBRID_BATCH
# prompts through ssm_prefill and LLM_NEW greedy decode steps, KV caches of
# HYBRID_MAX_LEN rows; every kernel-7 call of a decode step at M =
# HYBRID_BATCH and every mixer call (as ssm_plain_check) within
# SSM_MIXER_ULPS of its plain version; the chunked forward against the
# recurrence per layer within SSM_LAYER_RTOL.  whisper-medium: ENCDEC_BATCH
# seeded utterances of enc_seq frames through `encode`, an ENCDEC_PROMPT-
# token decoder prompt teacher-forced through `decode_step` (its last
# logits within LOGIT_TOL of `forward_logits`), then LLM_NEW greedy steps;
# each encoder layer (M = ENCDEC_BATCH x enc_seq) and decoder layer (M =
# ENCDEC_BATCH) with the plain matmul on the kernel run's input, its
# increment within ENCDEC_LAYER_ULPS bf16 ulps of the position's largest
# |increment|: a layer rounds its output to bf16 at two residual adds, and
# the encoder's input (seeded frames plus positions) is up to 4x its
# increments, so one output rounding is up to 4 ulps of the increment (on
# an H100 80GB HBM3 at 700 W the encoder's layers measured 2-4, the
# decoder's 0); each projection of those runs is held on its own within
# SSM_MIXER_ULPS (`kernel_vs_plain`).  llava-next-mistral-7b: the LLM path's requests through
# LLMExecutor (text only, as the reference serves vlm), then
# `forward_loss` at batch 1 over img_tokens seeded patches and VLM_TEXT
# text tokens, its loss within VLM_LOSS_TOL of the plain matmul's (the
# mean cross-entropy of 64 positions whose logits agree within LOGIT_TOL)
HYBRID_ARCH, ENCDEC_ARCH, VLM_ARCH = (
    "zamba2-2.7b", "whisper-medium", "llava-next-mistral-7b")
HYBRID_BATCH, HYBRID_MAX_LEN = 4, 256
# depth cuts of the ssm and hybrid paths (full width; every check kept):
# 16 of mamba2-780m's 48 layers, 3 of zamba2-2.7b's 9 attn_every periods
# (18 of 54 layers), so the script keeps within its time with the GPipe
# and model-axis path (PERF.md section 4)
SSM_PATH_LAYERS, HYBRID_PATH_LAYERS = 16, 18
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_MAX_LEN, ENCDEC_LAYER_ULPS = 2, 8, 64, 8
VLM_TEXT, VLM_LOSS_TOL = 64, 2.0 ** -5
SERVE_BUCKETS, SERVE_REQUESTS, SERVE_POOL = (1, 2, 4, 8), 256, 256
INTERACTIVE_FRAC, OVERLOAD, TARGET_MULT, BATCH_DEADLINE_MULT = (
    0.25, 3.0, 5.0, 60.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# -- phase 3: kernels against their plain versions ---------------------------


def _case(rng, torch, *, n, h, w, cin, cout, k=3, stride=(1, 1),
          padding=True, pool=None, fuse=True, const=True):
    dev = DEVICE
    x = torch.as_tensor(rng.integers(-1, 2, (n, h, w, cin)), dtype=torch.int8,
                        device=dev)
    wt = torch.as_tensor(rng.integers(-1, 2, (k, k, cin, cout)),
                         dtype=torch.int8, device=dev)
    kw = dict(stride=stride, padding=padding, pool=pool)
    if fuse:
        scale = pool[1] ** 2 if pool and pool[0] == "avg" else 1
        t_hi = rng.uniform(-20, 20, cout) * scale
        t_hi[::2] = np.round(t_hi[::2])     # integer thresholds: ties count
        t_lo = t_hi - rng.uniform(0, 30, cout) * scale
        f32 = dict(dtype=torch.float32, device=dev)
        kw.update(t_lo=torch.as_tensor(t_lo, **f32),
                  t_hi=torch.as_tensor(t_hi, **f32),
                  flip=torch.as_tensor(rng.random(cout) < 0.4, device=dev))
        if const:
            kw.update(const=torch.as_tensor(rng.integers(-1, 2, cout),
                                            dtype=torch.int8, device=dev),
                      is_const=torch.as_tensor(rng.random(cout) < 0.2,
                                               device=dev))
    return x, wt, kw


def _err(torch, got, want) -> int:
    """Max |got - want| over a tensor or a tuple of tensors."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in pairs)


def conv_cases() -> list[dict]:
    """Phase 3's conv cases: the main path's layer shapes, then odd
    channels, strides 2 and 3, unpadded, raw int32 and const-free cases,
    then the edges of the kernels' planner (`conv_plan`): maps that are
    not multiples of the tile, Cout over more than one slice and ragged,
    Cin 126 raw, avg 4 on a 4 x 4 map, packed rows whose length is not a
    multiple of 5, the wide plans (`WIDE_CONV`), and the shapes the
    compiler's lowerings give (`COMPILED_CONV`)."""
    cases = []
    hw, cin = CIFAR_HW, CIFAR_CIN
    for pool in CIFAR_POOLS:                   # the main path's layer shapes
        cases.append(dict(n=BATCH, h=hw, w=hw, cin=cin, cout=CIFAR_WIDTH,
                          pool=pool))
        hw, cin = (hw // pool[1] if pool else hw), CIFAR_WIDTH
    return cases + [
        dict(n=3, h=11, w=9, cin=13, cout=20, pool=("max", 2)),
        dict(n=2, h=17, w=17, cin=8, cout=5, stride=(2, 2)),
        dict(n=2, h=16, w=15, cin=16, cout=13, stride=(2, 2),
             padding=False, pool=("avg", 2)),
        dict(n=2, h=9, w=9, cin=6, cout=33, stride=(3, 3), pool=("avg", 3)),
        dict(n=2, h=10, w=10, cin=7, cout=9, padding=False, const=False),
        dict(n=2, h=8, w=8, cin=7, cout=9, fuse=False),
        dict(n=3, h=11, w=9, cin=16, cout=33, pool=("max", 2)),
        dict(n=2, h=17, w=17, cin=32, cout=160),
        dict(n=BATCH, h=CIFAR_HW, w=CIFAR_HW, cin=CIFAR_CIN,
             cout=CIFAR_WIDTH, fuse=False),
        dict(n=3, h=12, w=12, cin=16, cout=20, stride=(3, 3),
             pool=("avg", 3)),
        dict(n=5, h=4, w=4, cin=64, cout=33, pool=("avg", 4)),
        dict(n=2, h=7, w=12, cin=7, cout=9, pool=("max", 2)),
    ] + WIDE_CONV + COMPILED_CONV


# shapes of compiled programs (phase 4): the CIFAR dense head lowered to a
# 1 x 1 unpadded conv on the 1 x 1 map, a dense head over a 3 x 3 map (an
# unpadded 3 x 3 conv to 1 x 1), the residual add (a 1 x 1 conv over body
# and skip channels, 40 -> 20), a body conv widened to 40, an identity
# 1 x 1 conv carrying an avg pool, and pad_to = 16 behind Cin 5
COMPILED_CONV = [
    dict(n=BATCH, h=1, w=1, cin=128, cout=10, k=1, padding=False),
    dict(n=2, h=3, w=3, cin=20, cout=10, padding=False),
    dict(n=2, h=12, w=12, cin=40, cout=20, k=1),
    dict(n=2, h=12, w=12, cin=20, cout=40),
    dict(n=2, h=8, w=8, cin=6, cout=6, k=1, pool=("avg", 2)),
    dict(n=2, h=8, w=8, cin=5, cout=16),
]


# avg windows whose sums pass int16 at 128 channels (the planners' `wide`
# plans, the int32 epilogue): avg 6 on 12 x 12, avg 8 on 8 x 8 (global)
WIDE_CONV = [dict(n=3, h=12, w=12, cin=128, cout=128, pool=("avg", 6)),
             dict(n=3, h=8, w=8, cin=128, cout=128, pool=("avg", 8))]


def compare_kernels(torch, K, codec) -> dict:
    rng = np.random.default_rng(SEED)
    cases = conv_cases()
    worst = {name: 0 for name in REPLACES}
    for i, c in enumerate(cases):
        x, w, kw = _case(rng, torch, **c)
        stats = "t_lo" in kw
        want = K.ternary_conv2d_plain(x, w, emit_stats=stats, **kw)
        wp = codec.pack_filter_rows(w)
        k, _, cin_, _ = w.shape
        got = {"ternary_conv2d": K.ternary_conv2d(x, w, emit_stats=stats,
                                                  **kw),
               "ternary_conv2d_packed": K.ternary_conv2d_packed(
                   x, wp, k=k, cin=cin_, emit_stats=stats, **kw)}
        sync(torch)
        for name, y in got.items():
            err = _err(torch, y, want)
            worst[name] = max(worst[name], err)
            if err != 0:
                raise RuntimeError(f"{name} disagrees with its plain "
                                   f"version on case {i} {c}: max |err| "
                                   f"{err}")
    log(f"phase 3: {len(cases)} cases x 2 conv kernels bit-identical to "
        "the plain versions (outputs and counters)")
    return worst


def _trunk_case(rng, torch, *, n, hw, cin, c, pools, strides=None, k=3):
    """Random trunk operands: x, w_stack (head rows zero-padded), the five
    stacked epilogue vectors and the metas."""
    nl, cu, dev = len(pools), max(cin, c), DEVICE
    w = rng.integers(-1, 2, (nl, k, k, cu, c)).astype(np.int8)
    w[0, :, :, cin:] = 0
    scale = np.array([p[1] ** 2 if p and p[0] == "avg" else 1
                      for p in pools])[:, None]
    t_hi = rng.uniform(-20, 20, (nl, c)) * scale
    t_hi[:, ::2] = np.round(t_hi[:, ::2])
    t_lo = t_hi - rng.uniform(0, 30, (nl, c)) * scale
    f32 = dict(dtype=torch.float32, device=dev)
    th = [torch.as_tensor(t_lo, **f32), torch.as_tensor(t_hi, **f32),
          torch.as_tensor(rng.random((nl, c)) < 0.4, device=dev),
          torch.as_tensor(rng.integers(-1, 2, (nl, c)), dtype=torch.int8,
                          device=dev),
          torch.as_tensor(rng.random((nl, c)) < 0.2, device=dev)]
    x = torch.as_tensor(rng.integers(-1, 2, (n, *hw, cin)), dtype=torch.int8,
                        device=dev)
    return x, torch.as_tensor(w, device=dev), th, trunk_metas(
        dict(pools=pools, strides=strides))


def trunk_cases() -> list[dict]:
    """Phase 3's trunk cases: the full CIFAR trunk at batch 64 (its head,
    Cin 126, on the raw-copy path), then the edges of the trunk planner
    (`trunk_plan`): C = 13 (a partial slice) behind a head of 6, stride 2
    with avg 2, avg 4 on a 4 x 4 map into a 1 x 1 layer (C = 33 behind a
    head of 64: weight rows at Cu = 64, the second layer on the raw path),
    N = 1 with fewer tiles than blocks, a 16-layer trunk, and the two
    wide trunks: a plain layer, then avg 6 on 12 x 12 or avg 8 on 8 x 8
    at 128 channels, and the 1 x 1 trunk a compiled residual block gives
    (the add, Cin 40 -> 20, then an identity conv with a max pool)."""
    return [dict(n=BATCH, hw=(CIFAR_HW, CIFAR_HW), cin=CIFAR_CIN,
                 c=CIFAR_WIDTH, pools=CIFAR_POOLS),
            dict(n=3, hw=(11, 9), cin=6, c=13,
                 pools=(None, ("max", 2), None)),
            dict(n=2, hw=(17, 15), cin=16, c=16,
                 pools=(None, ("avg", 2), None),
                 strides=[(2, 2), (1, 1), (1, 1)]),
            dict(n=5, hw=(4, 4), cin=64, c=33, pools=(("avg", 4), None)),
            dict(n=1, hw=(8, 8), cin=16, c=32,
                 pools=(None, ("max", 2), None)),
            dict(n=2, hw=(16, 16), cin=8, c=16,
                 pools=(None, None, None, ("max", 2)) + (None,) * 3
                 + (("max", 2),) + (None,) * 8),
            dict(n=2, hw=(6, 6), cin=40, c=20, pools=(None, ("max", 2)),
                 k=1)] + [
            dict(n=c["n"], hw=(c["h"], c["w"]), cin=c["cin"], c=c["cout"],
                 pools=(None, c["pool"])) for c in WIDE_CONV]


def trunk_metas(spec) -> tuple:
    """A trunk case's (stride, pool) per layer."""
    strides = spec.get("strides") or [(1, 1)] * len(spec["pools"])
    return tuple(zip(strides, spec["pools"]))


def kv_rows(rng, torch, r, n, dtype):
    """(r, n) seeded KV rows on the card with exact ties at half the row's
    max, all-zero rows and signed zeros (as tests/test_torch_cuda.py's)."""
    x = rng.standard_normal((r, n)).astype(np.float32)
    m = 2.0 ** rng.integers(-3, 4, r) * np.where(np.arange(r) % 2, -1, 1)
    x = np.clip(x, -np.abs(m)[:, None], np.abs(m)[:, None])
    x[:, 0] = m
    x[::3, 1::3] = (m / 2)[::3, None]
    x[::3, 2::3] = (-m / 2)[::3, None]
    x[1::11] = 0.0
    x[2::11] = -0.0
    x[3::11, ::2] = -0.0
    return torch.as_tensor(x, device=DEVICE).to(getattr(torch, dtype))


def kv_packed(rng, torch, r, g):
    """(r, g) packed KV rows and (r,) f32 scales on the card, 0 and -0.0
    among the scales."""
    b = torch.as_tensor(rng.integers(0, 243, (r, g)), dtype=torch.uint8,
                        device=DEVICE)
    s = torch.as_tensor(rng.standard_normal(r), dtype=torch.float32,
                        device=DEVICE)
    s[:2] = torch.as_tensor([0.0, -0.0])
    return b, s


def compare_new_kernels(torch, FT, TC, worst: dict) -> None:
    """The trunk, codec and thermometer kernels against their plain
    versions on the card, counters included: the trunk past the old int16
    limit (`WIDE_CONV`), the codec on the split's boundary and ragged,
    flat and unaligned shapes, and its KV store forms at the trit serve's
    shapes and odd ones (bf16 compared bit for bit)."""
    rng = np.random.default_rng(SEED + 3)
    cases = trunk_cases()
    full = cases[0]
    n_cases = 0

    def check(got, want, what):
        nonlocal n_cases
        sync(torch)
        err = _err(torch, got, want)
        name = what.split(" ")[0]
        worst[name] = max(worst[name], err)
        n_cases += 1
        if err != 0:
            raise RuntimeError(f"{what} disagrees with its plain version: "
                               f"max |err| {err}")

    for spec in cases:
        x, w, th, metas = _trunk_case(rng, torch, **spec)
        kw = dict(metas=metas, emit_stats=True)
        check(FT.fused_trunk(x, w, *th, **kw),
              FT.fused_trunk_plain(x, w, *th, **kw),
              f"fused_trunk on {tuple(x.shape)} -> C {spec['c']}, "
              f"{len(metas)} layers")
    # the main path's split: [0, SPLIT_AT) packs, [SPLIT_AT, 8) unpacks
    x, w, th, metas = _trunk_case(rng, torch, **full)
    a = dict(metas=metas[:SPLIT_AT], pack_out=True, emit_stats=True)
    a_args = (x, w[:SPLIT_AT], *[t[:SPLIT_AT] for t in th])
    got_a = FT.fused_trunk(*a_args, **a)
    check(got_a, FT.fused_trunk_plain(*a_args, **a),
          "fused_trunk pack_out at the split")
    mid = FT.fused_trunk_plain(*a_args, metas=metas[:SPLIT_AT])
    b = dict(metas=metas[SPLIT_AT:], packed_in=tuple(mid.shape),
             emit_stats=True)
    b_args = (got_a[0], w[SPLIT_AT:, :, :, :CIFAR_WIDTH].contiguous(),
              *[t[SPLIT_AT:] for t in th])
    check(FT.fused_trunk(*b_args, **b), FT.fused_trunk_plain(*b_args, **b),
          "fused_trunk packed_in at the split")
    # codec at the split's boundary and at ragged lengths
    flat = mid.reshape(-1)
    for t in (mid.reshape(1, -1), flat[:7 * 643].reshape(7, 643),
              torch.as_tensor(rng.integers(-1, 2, (3, 1003)),
                              dtype=torch.int8, device=DEVICE),
              flat[:64 * 800].reshape(64, 800),          # W % 5 == 0
              flat[3:3 + 2 * 80013].reshape(2, 80013)):  # unaligned view
        packed = TC.pack_trits(t)
        check(packed, TC.pack_trits_plain(t),
              f"pack_trits on {tuple(t.shape)}")
        check(TC.unpack_trits(packed), TC.unpack_trits_plain(packed),
              f"unpack_trits on {tuple(packed.shape)}")
    every = torch.arange(256, dtype=torch.uint8, device=DEVICE).repeat(9)
    check(TC.unpack_trits(every[5:].reshape(1, -1)),
          TC.unpack_trits_plain(every[5:].reshape(1, -1)),
          "unpack_trits on every byte value, unaligned")
    # the KV store's forms: one decode step's K write (16 x 4 x 8 rows)
    # and K gather (16 x 4 x 16 x 16 x 8 rows of 13 bytes) at full width
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for r, n in ((512, 64), (8192, 64), (37, 13), (5, 1)):
        for dtype in ("bfloat16", "float32"):
            x = kv_rows(rng, torch, r, n, dtype)
            got, want = TC.ternarize_pack(x), TC.ternarize_pack_plain(x)
            check((got[0], got[1].view(torch.int32)),
                  (want[0], want[1].view(torch.int32)),
                  f"pack_trits ternarize_pack on {dtype} ({r}, {n})")
    for r, g, n in ((KV_ROWS, 13, 64), (77, 8, 37), (9, 1, 5)):
        b, sc = kv_packed(rng, torch, r, g)
        got = TC.unpack_dequant(b, sc, n)
        want = TC.unpack_dequant_plain(b, sc, n)
        check(got.view(bits[got.dtype]), want.view(bits[want.dtype]),
              f"unpack_trits unpack_dequant on ({r}, {g}) -> {n}")
    n_thermo = thermometer_cases(torch, TC, rng, check)
    log(f"phase 3: {n_cases} trunk, codec and thermometer cases "
        "bit-identical to the plain versions (outputs and counters), the "
        f"wide trunks {[c['pool'] for c in WIDE_CONV]} at 128 channels, "
        f"the codec's KV forms and {n_thermo} thermometer cases (levels "
        "and image forms, every m in 1..17 and 42, ties, out-of-range "
        "values, +-inf and NaN, odd lengths, unaligned views) included")


THERMO_MS = tuple(range(1, 18)) + (THERMO_M,)


def thermo_image(rng, torch, m, ternary, n):
    """(n,) f32 pixels on the card: exact ties at k + 0.5 levels, both
    ends, values below 0 and above 1, -0.0, +-inf and NaN."""
    lv = 2 * m if ternary else m
    img = rng.random(n).astype(np.float32)
    k = rng.integers(0, lv, 40)
    img[:40] = ((k + 0.5) / lv).astype(np.float32)
    img[40:52] = [0.0, 1.0, -0.0, -0.3, 1.7, -5.0, 9.0, np.inf, -np.inf,
                  np.nan, -np.nan, 0.5 / lv]
    return torch.as_tensor(img, device=DEVICE)


def thermometer_cases(torch, TC, rng, check) -> int:
    """Kernel 6 in both forms against its plain versions: the CIFAR input
    (levels, and the image batch as the main path encodes it), then every
    m from 1 to 17 and 42 (16-byte pieces across 1 to 16 rows), levels
    out of range, images with ties, +-inf and NaN, lengths that are not a
    multiple of 16 and views at an odd offset.  Returns the case count."""
    n = 0
    shape = (BATCH, CIFAR_HW, CIFAR_HW, 3)
    levels = torch.as_tensor(rng.integers(0, 2 * THERMO_M + 1, shape),
                             dtype=torch.int32, device=DEVICE)
    img = torch.as_tensor(rng.random(shape), dtype=torch.float32,
                          device=DEVICE)
    img.view(-1)[:52] = thermo_image(rng, torch, THERMO_M, True, 52)
    for ternary in (True, False):
        kind = "ternary" if ternary else "binary"
        lv = levels if ternary else levels.clamp(max=THERMO_M)
        check(TC.thermometer(lv, THERMO_M, ternary=ternary),
              TC.thermometer_plain(lv, THERMO_M, ternary=ternary),
              f"thermometer {kind} on {tuple(lv.shape)}")
        check(TC.encode_image(img, THERMO_M, ternary=ternary),
              TC.encode_image_plain(img, THERMO_M, ternary=ternary),
              f"thermometer encode_image {kind} on {tuple(img.shape)}")
        n += 2
        for m in THERMO_MS:
            lv = torch.as_tensor(rng.integers(-3, 2 * m + 4, 1003),
                                 dtype=torch.int32, device=DEVICE)
            im = thermo_image(rng, torch, m, ternary, 3 * 331)
            for v in (lv, lv[1:], lv[5:5 + 7 * 13].reshape(7, 13)):
                check(TC.thermometer(v, m, ternary=ternary),
                      TC.thermometer_plain(v, m, ternary=ternary),
                      f"thermometer {kind} m {m} on {tuple(v.shape)}")
            for v in (im.reshape(331, 3), im[1:],
                      im[3:3 + 5 * 6 * 3].reshape(5, 6, 3)):
                check(TC.encode_image(v, m, ternary=ternary),
                      TC.encode_image_plain(v, m, ternary=ternary),
                      f"thermometer encode_image {kind} m {m} on "
                      f"{tuple(v.shape)}")
            n += 6
    return n


def _mm_case(rng, torch, m, k, n, xdt, ep):
    """x, w_packed and the epilogue operands of one matmul case."""
    dev = DEVICE
    if xdt == "int8":
        x = torch.as_tensor(rng.integers(-1, 2, (m, k)), dtype=torch.int8)
    else:
        x = torch.as_tensor(rng.standard_normal((m, k)),
                            dtype=torch.float32).to(getattr(torch, xdt))
    wp = torch.as_tensor(rng.integers(0, 243, (-(-k // 5), n)),
                         dtype=torch.uint8)
    f32 = dict(dtype=torch.float32, device=dev)
    kw = {}
    if ep in ("scale", "scale+round"):
        kw["scale"] = torch.as_tensor(rng.uniform(0.01, 0.05, n), **f32)
        if ep == "scale+round":              # alpha rounded as `linear` asks
            kw["round_scale"] = True
    elif ep == "threshold":
        t_hi = np.round(rng.uniform(-8, 8, n))
        kw = dict(t_lo=torch.as_tensor(t_hi - rng.uniform(0, 10, n), **f32),
                  t_hi=torch.as_tensor(t_hi, **f32),
                  flip=torch.as_tensor(rng.random(n) < 0.4, device=dev))
    return x.to(dev), wp.to(dev), kw


def compare_matmul_kernels(torch, MM, worst: dict) -> None:
    """Kernels 7 and 8 against their plain versions on the card: every
    epilogue, int8 and bf16 x, M in {1, 4, 37, 128}, ragged N and a logical
    K that is not a multiple of 5, then the seven llama projections at the
    decode and prefill M; the scale epilogue with ``round_scale`` (as
    `linear` calls it) for bf16 and f16 x at the same shapes.  Int8 x
    bit-identical; float x within the stated tolerance (a threshold may
    flip a trit whose sum lies within rounding of it: at most 1 in
    1000)."""
    rng = np.random.default_rng(SEED + 5)
    cases = [(m, 1001, 77, xdt, ep) for m in (1, 4, 37, 128)
             for xdt in ("int8", "bfloat16")
             for ep in ("none", "scale", "threshold")]
    cases += [(m, k, n, xdt, "scale") for m in (DECODE_M, PREFILL_M)
              for _, k, n in LLM_PROJ for xdt in ("int8", "bfloat16")]
    cases += [(m, k, n, xdt, "scale+round")
              for m, k, n in [(m, 1001, 77) for m in (1, 4, 37, 128)]
              + [(m, k, n) for m in (DECODE_M, PREFILL_M)
                 for _, k, n in LLM_PROJ]
              for xdt in ("bfloat16", "float16")]
    tols = {torch.bfloat16: BF16_OUT_TOL, torch.float16: F16_OUT_TOL,
            torch.float32: F32_OUT_TOL}
    rel = dict.fromkeys(tols, 0.0)
    flips = 0.0
    for m, k, n, xdt, ep in cases:
        x, wp, kw = _mm_case(rng, torch, m, k, n, xdt, ep)
        got = MM.ternary_matmul(x, wp, **kw)
        want = MM.ternary_matmul_plain(x, wp, **kw)
        sync(torch)
        what = f"ternary_matmul {xdt} x ({m}, {k}) N {n} epilogue {ep}"
        if got.dtype != want.dtype or got.shape != want.shape:
            raise RuntimeError(f"{what}: {got.dtype} {tuple(got.shape)}, "
                               f"want {want.dtype} {tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max())
        worst["ternary_matmul"] = max(worst["ternary_matmul"], err)
        if xdt == "int8":
            if err != 0:
                raise RuntimeError(f"{what} differs: max |err| {err}")
        elif ep == "threshold":
            share = float((got != want).double().mean())
            flips = max(flips, share)
            if share > 1e-3:
                raise RuntimeError(f"{what}: {share} of trits flipped")
        else:
            scale = float(want.double().abs().max())
            tol = tols[got.dtype]
            rel[got.dtype] = max(rel[got.dtype], err / scale)
            if err > tol * scale:
                raise RuntimeError(f"{what}: max |err| {err} > {tol} x "
                                   f"{scale}")
    dense = [(m, 1001, 77) for m in (1, 4, 37, 128)]
    dense += [(m, k, n) for m in (DECODE_M, PREFILL_M)
              for _, k, n in LLM_PROJ]
    for m, k, n in dense:
        x = torch.as_tensor(rng.integers(-128, 128, (m, k)), dtype=torch.int8,
                            device=DEVICE)
        w = torch.as_tensor(rng.integers(-1, 2, (k, n)), dtype=torch.int8,
                            device=DEVICE)
        got = MM.ternary_matmul_dense(x, w)
        want = MM.ternary_matmul_dense_plain(x, w)
        sync(torch)
        err = _err(torch, got, want)
        worst["ternary_matmul_dense"] = max(worst["ternary_matmul_dense"],
                                            err)
        if got.dtype != torch.int32 or err != 0:
            raise RuntimeError(f"ternary_matmul_dense ({m}, {k}) N {n}: "
                               f"max |err| {err}")
    rows_invariant(torch, MM, rng)
    round_scale_exact(torch, MM, rng)
    log(f"phase 3: ternary_matmul on {len(cases)} cases: int8 x "
        "bit-identical; float x worst |err| / max|out| "
        f"{rel[torch.bfloat16]!r} (bf16 out, tolerance {BF16_OUT_TOL!r}), "
        f"{rel[torch.float16]!r} (f16 out, tolerance {F16_OUT_TOL!r}), "
        f"{rel[torch.float32]!r} (f32 out, tolerance {F32_OUT_TOL!r}), "
        f"threshold flips at most {flips!r}; worst absolute error "
        f"{worst['ternary_matmul']!r}; ternary_matmul_dense on {len(dense)} "
        "cases bit-identical")


def rows_invariant(torch, MM, rng) -> None:
    """Kernel 7's rows at M in INVARIANT_M against the same rows at M =
    128, bit for bit, for bf16 and int8 x at the seven llama projections:
    the K split and the sum order must not depend on M (a prompt's rows
    run at M = 64 cold, 16 on a prefix hit, 4 in decode)."""
    checked = 0
    for _, k, n in LLM_PROJ:
        for xdt in ("bfloat16", "int8"):
            x, wp, kw = _mm_case(rng, torch, 128, k, n, xdt, "scale")
            for ep in ({}, dict(kw, round_scale=xdt != "int8")):
                full = MM.ternary_matmul(x, wp, **ep)
                for m in INVARIANT_M:
                    got = MM.ternary_matmul(x[:m], wp, **ep)
                    sync(torch)
                    bits = {4: torch.int32, 2: torch.int16}[got.element_size()]
                    if not torch.equal(got.view(bits), full[:m].view(bits)):
                        raise RuntimeError(
                            f"ternary_matmul {xdt} x ({m}, {k}) N {n} "
                            f"{'scale' if ep else 'none'}: rows differ from "
                            "the same rows at M = 128")
                    checked += 1
    log(f"phase 3: ternary_matmul rows at M in {INVARIANT_M} bit-identical "
        f"to the same rows at M = 128 ({checked} cases: bf16 and int8 x, "
        "no epilogue and scale, the seven llama projections)")


def round_scale_exact(torch, MM, rng) -> None:
    """Kernel 7 with ``round_scale=True``, as every call on the main path
    makes it, against the kernel handed scale already rounded to x's type:
    the same plan and sum order, so the same bits.  The unrounded call's
    bits must differ, so that a kernel which skipped the rounding, or
    rounded to another type, would fail here.  bf16 and f16 x, the seven
    llama projections at the decode and prefill M."""
    checked = 0
    for m in (DECODE_M, PREFILL_M):
        for pname, k, n in LLM_PROJ:
            for xdt in ("bfloat16", "float16"):
                x, wp, kw = _mm_case(rng, torch, m, k, n, xdt, "scale")
                s = kw["scale"]
                got = MM.ternary_matmul(x, wp, scale=s, round_scale=True)
                pre = MM.ternary_matmul(x, wp, scale=s.to(x.dtype).float())
                raw = MM.ternary_matmul(x, wp, scale=s)
                sync(torch)
                what = f"ternary_matmul {xdt} x ({m}, {k}) N {n} round_scale"
                if not torch.equal(got.view(torch.int16),
                                   pre.view(torch.int16)):
                    raise RuntimeError(f"{what}: bits differ from the call "
                                       "with scale rounded beforehand")
                if torch.equal(got.view(torch.int16), raw.view(torch.int16)):
                    raise RuntimeError(f"{what}: bits equal the unrounded "
                                       "call's, so the check cannot see the "
                                       "rounding")
                checked += 1
    log(f"phase 3: ternary_matmul round_scale=True bit-identical to scale "
        f"rounded beforehand, and different from scale unrounded ({checked} "
        "cases: bf16 and f16 x, the seven llama projections at M = "
        f"{DECODE_M} and {PREFILL_M})")


def log_trunk_plan(FT, spec) -> None:
    """Phase 2: the trunk planner's launch and per-layer plan of a trunk
    case."""
    metas = trunk_metas(spec)
    h, w = spec["hw"]
    cu = max(spec["cin"], spec["c"])
    plan = FT.trunk_plan(spec["n"], h, w, spec["cin"], spec["c"], cu, 3,
                         metas, spec["cin"])
    log(f"  trunk plan, batch {spec['n']}, {len(metas)} layers: "
        f"{plan['groups']} pipelines per block ({plan['threads']} threads), "
        f"{plan['smem']} B of dynamic shared memory, grid {plan['grid']}")
    for li, g in enumerate(plan["layers"]):
        tiles = g["n"] * g["tiles_r"] * g["tiles_c"]
        log(f"    layer {li}: {g['h']}x{g['w']}x{g['cin']} (weight rows "
            f"{g['w_rows']}), tile {g['th']}x{g['tw']}, Cout slice "
            f"{g['ns']} x {g['slices']}, {g['gpb']} blocks per slice, "
            f"{tiles * g['slices']} (tile, slice) pairs, "
            f"{'direct' if g['direct'] else 'raw'} patch copy, "
            f"{g['smem']} B")


# -- phase 4: the main path --------------------------------------------------


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def reset_launches(*mods) -> None:
    for m in mods:
        m.reset_launches()


def _w(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bn(rng, c):
    return {"gamma": rng.standard_normal(c).astype(np.float32) + 0.5,
            "beta": np.zeros(c, np.float32), "mean": np.zeros(c, np.float32),
            "var": np.ones(c, np.float32)}


def cifar_arrays():
    """Seeded float weights and BN of the CIFAR-10 network's 8 conv layers,
    with their pools, then the dense 128 -> 10 head's weights."""
    rng = np.random.default_rng(SEED + 1)
    layers, cin = [], CIFAR_CIN
    for pool in CIFAR_POOLS:
        w = _w(rng, (3, 3, cin, CIFAR_WIDTH))
        layers.append((w, _bn(rng, CIFAR_WIDTH), pool))
        cin = CIFAR_WIDTH
    return layers, _w(rng, (cin, CIFAR.n_classes))


def cifar_program(torch, engine):
    """The hand-built 8-layer program, layer by layer with
    `engine.compile_layer`: the oracle of the compiled one."""
    layers = [engine.compile_layer(torch.as_tensor(w, device=DEVICE), bn,
                                   pool=pool)
              for w, bn, pool in cifar_arrays()[0]]
    return engine.CutieProgram(layers, engine.CutieInstance())


def cifar_graph(compiler, include_head: bool):
    """The same network as a `compiler.Graph` (as the reference's
    `models.cutie_cnn.to_graph` emits it), with the head when asked."""
    layers, head = cifar_arrays()
    g = compiler.Graph(in_channels=CIFAR_CIN, in_hw=(CIFAR_HW, CIFAR_HW))
    for w, bn, pool in layers:
        g.conv(w, bn, pool=pool)
    if include_head:
        g.dense(head)
    return g


def same_program(torch, got, want) -> list:
    """The fields in which two programs differ (empty when every array,
    thresholds by their bits, and every stride, padding and pool is
    equal)."""
    bad = []
    if len(got.layers) != len(want.layers):
        return [f"{len(got.layers)} layers, want {len(want.layers)}"]
    for i, (a, b) in enumerate(zip(got.layers, want.layers)):
        if not torch.equal(a.weights, b.weights.to(a.weights.device)):
            bad.append(f"layer {i} weights")
        for f in ("t_lo", "t_hi", "flip", "const", "is_const"):
            x, y = getattr(a.thresholds, f), getattr(b.thresholds, f)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y.to(x.device)):
                bad.append(f"layer {i} {f}")
        if (a.stride, a.padding, a.pool) != (b.stride, b.padding, b.pool):
            bad.append(f"layer {i} stride/padding/pool")
    return bad


def cifar_input(torch, thermometer):
    rng = np.random.default_rng(SEED + 2)
    img = torch.as_tensor(rng.random((BATCH, CIFAR_HW, CIFAR_HW, 3)),
                          dtype=torch.float32, device=DEVICE)
    return thermometer.encode_image_ternary(img, THERMO_M)


def _run_steps(torch, P, pipe, x, count, per_run: tuple, what: str) -> dict:
    """run, traced run and measure on one pipeline; ``count()`` (a tuple
    of launch counts) must grow by ``per_run`` per step."""
    steps = [("run", lambda: pipe.run(x)),
             ("run+StatsTracer", lambda: pipe.run(x, tracer=P.StatsTracer())),
             ("measure", lambda: pipe.measure(x))]
    got = {}
    for i, (step, fn) in enumerate(steps, 1):
        got[step] = fn()
        sync(torch)
        want = tuple(n * i for n in per_run)
        if count() != want:
            raise RuntimeError(f"{what}: launches {count()} after {step}, "
                               f"want {want}")
    return got


def _same(a, b) -> bool:
    """Equal, with a float NaN equal to NaN: the priced toggle rate of a
    layer whose output is one window per image is 0/0 (NaN), in the
    reference's energy model as in the port's."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and isinstance(b, float) and a != a:
        return b != b
    return a == b


def _same_as_ref(torch, got, ref: dict, what: str) -> None:
    y, (y2, rows), m = got["run"], got["run+StatsTracer"], got["measure"]
    checks = {
        "run": torch.equal(y, ref["y"]),
        "traced run": torch.equal(y2, ref["y"]),
        "tracer rows": _same(rows, ref["rows"]),
        "measure final": torch.equal(m["final"], ref["y"]),
        "measure rows": _same(m["layers"], ref["m"]["layers"]),
        "energy_uj": _same(m["energy_uj"], ref["m"]["energy_uj"]),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise RuntimeError(f"{what} differs from ref on {bad}")


def _ref_run(P, pipe, x) -> dict:
    _, rows = pipe.run(x, tracer=P.StatsTracer())
    return {"y": pipe.run(x), "rows": rows, "m": pipe.measure(x)}


def every_backend(torch, K, FT, P, compiled, x, split_budget, what: str
                  ) -> dict:
    """A compiled program (``compiled``, a CompileResult) on ``cuda``,
    ``packed``, ``fused`` and, with ``split_budget``, ``fused`` under that
    L2 budget: run, traced run and measure must equal ``ref`` on the
    card, each backend's launches must grow per step by one conv launch
    per layer (``cuda``, ``packed``) or, on ``fused``, by one trunk launch
    per fused segment and one conv launch per layer of the per-layer
    segments, as `execution_plan` reports them.  Returns the launches of
    each backend's three steps and the fused segments."""
    ref = _ref_run(P, compiled.pipeline("ref", device=DEVICE), x)
    n = len(compiled.program.layers)
    backends = {"cuda": "cuda", "packed": "packed", "fused": "fused"}
    if split_budget is not None:
        backends["fused-split"] = P.FusedBackend(l2_budget=split_budget)
    out = {"ref": ref, "segments": {}}
    for label, be in backends.items():
        pipe = compiled.pipeline(be, device=DEVICE)
        if label.startswith("fused"):
            segs = pipe.execution_plan(tuple(x.shape))["segments"]
            trunks = sum(s["fused"] for s in segs)
            per = (trunks, sum(s["stop"] - s["start"] for s in segs
                               if not s["fused"]), 0)
            out["segments"][label] = [(s["start"], s["stop"], s["fused"])
                                      for s in segs]
        else:
            per = (0, n, 0) if label == "cuda" else (0, 0, n)
        if DEVICE != "cuda":
            per = (0, 0, 0)
        reset_launches(K, FT)

        def count():
            return (FT.LAUNCHES["fused_trunk"], K.LAUNCHES["ternary_conv2d"],
                    K.LAUNCHES["ternary_conv2d_packed"])

        got = _run_steps(torch, P, pipe, x, count, per, f"{what} {label}")
        _same_as_ref(torch, got, ref, f"{what} {label}")
        out[label] = count()
        log(f"phase 4: {what} on {label!r}"
            + (f" (segments {out['segments'][label]})"
               if label in out["segments"] else "")
            + ": run, traced run and measure identical to ref; launches "
            "(fused_trunk, ternary_conv2d, ternary_conv2d_packed) "
            f"{out[label]} = 3 x {per}")
    return out


def boundary_codec(torch, FT, TC, P, engine, ops, prog, x, what: str
                   ) -> tuple:
    """The codec entry points (kernels 4 and 5, one launch each) on the
    trits at the boundary of ``prog``'s two-trunk split (after layer
    ``SPLIT_AT``): the packed bytes must equal the trunk kernel's own
    ``pack_out`` stream and unpack to the same trits.  Returns the
    boundary and the two launch counts."""
    head = engine.CutieProgram(prog.layers[:SPLIT_AT], prog.instance)
    boundary = P.CutiePipeline(head, backend="fused", device=DEVICE).run(x)
    reset_launches(TC)
    packed = ops.pack_trits(boundary.reshape(1, -1))
    trits = ops.unpack_trits(packed)
    sync(torch)
    launches = {"pack_trits": TC.LAUNCHES["pack_trits"],
                "unpack_trits": TC.LAUNCHES["unpack_trits"]}
    if DEVICE == "cuda" and tuple(launches.values()) != (1, 1):
        raise RuntimeError(f"codec entry points launched {TC.LAUNCHES}")
    stream = FT.fused_trunk(
        x, *_trunk_operands(torch, prog.layers[:SPLIT_AT]),
        metas=tuple((li.stride, li.pool) for li in prog.layers[:SPLIT_AT]),
        pack_out=True)
    n = boundary.numel()
    if not (torch.equal(packed.reshape(-1), stream)
            and torch.equal(trits.reshape(-1)[:n], boundary.reshape(-1))):
        raise RuntimeError(f"codec entry points disagree with the trunk "
                           f"kernel's packed boundary ({what} program)")
    log(f"phase 4: pack_trits/unpack_trits on {what} split's boundary "
        f"{tuple(boundary.shape)}: bytes equal the trunk kernel's pack_out "
        "stream, round trip exact")
    return boundary, launches


def main_path(torch, K, FT, TC, ops, engine, thermometer, compiler, P
              ) -> dict:
    """The paper's CIFAR-10 network through `CutiePipeline.compile`:
    (a) head-less, unoptimized, it must equal the hand-built program
    array for array; (b) with the dense head and optimize=True, its
    batch-64 input encoded in one launch of kernel 6's image form, on
    every backend against ``ref``; then the codec on the split's
    boundary.  The compiled residual, pad_to and nonconforming programs
    follow (`compiled_programs`)."""
    hand = cifar_program(torch, engine)
    trunk = P.CutiePipeline.compile(cifar_graph(compiler, False),
                                    backend="ref", device=DEVICE,
                                    optimize=False).program
    bad = same_program(torch, trunk, hand)
    if bad:
        raise RuntimeError(f"compiled CIFAR program differs from the "
                           f"hand-built one: {bad}")
    log(f"phase 4: CutiePipeline.compile of the head-less CIFAR-10 graph "
        f"(optimize=False): {len(trunk.layers)} layers equal to the "
        "hand-built program array for array (trits, threshold bits, flags, "
        "stride, padding, pool)")
    pipe = P.CutiePipeline.compile(
        cifar_graph(compiler, True),
        instance=engine.CutieInstance(n_layers=CIFAR_DEPTH), backend="ref",
        device=DEVICE, batch=BATCH)
    compiled = pipe.compile_result
    prog = compiled.program
    log("phase 4: CutiePipeline.compile of the CIFAR-10 graph with its "
        f"dense head (optimize=True): {len(prog.layers)} layers, channels "
        f"{[li.weights.shape[-1] for li in prog.layers]}, folded "
        f"{compiled.folded_channels}, removed {compiled.removed_channels}; "
        f"cost report at batch {BATCH}:")
    for line in compiled.cost_table().splitlines():
        log(f"  {line}")
    on_cpu = P.CutiePipeline.compile(
        cifar_graph(compiler, True),
        instance=engine.CutieInstance(n_layers=CIFAR_DEPTH), backend="ref",
        device="cpu").program
    bad = same_program(torch, prog, on_cpu)
    if bad:
        raise RuntimeError(f"CIFAR-10 + head compiled on the card differs "
                           f"from the same graph compiled on the CPU: {bad}")
    log("phase 4: the CIFAR-10 graph with its head compiled on the card "
        "equals its compile with device='cpu' array for array (TWN "
        "reductions, correctly rounded sqrt and the fold run on each)")
    reset_launches(K, FT, TC)
    x = cifar_input(torch, thermometer)
    sync(torch)
    launches = {"thermometer": TC.LAUNCHES["thermometer"]}
    if launches["thermometer"] != 1 and DEVICE == "cuda":
        raise RuntimeError(f"input encoding launched the thermometer kernel "
                           f"{launches['thermometer']} times, want 1")
    if tuple(x.shape) != (BATCH, CIFAR_HW, CIFAR_HW, CIFAR_CIN):
        raise RuntimeError(f"thermometer input has shape {tuple(x.shape)}")
    split_budget = compiler.trunk_l2_bytes(prog.layers[:SPLIT_AT],
                                           tuple(x.shape))
    runs = every_backend(torch, K, FT, P, compiled, x, split_budget,
                         "CIFAR-10 + head")
    y_ref = runs["ref"]["y"]
    want_shape = (BATCH, 1, 1, CIFAR.n_classes)
    if tuple(y_ref.shape) != want_shape or not bool(
            ((y_ref >= -1) & (y_ref <= 1)).all()):
        raise RuntimeError(f"ref output {tuple(y_ref.shape)} is not "
                           f"{want_shape} trits")
    segs = runs["segments"]
    if len(segs["fused"]) < 2 or not segs["fused"][0][2] or \
            len(segs["fused-split"]) <= len(segs["fused"]):
        raise RuntimeError(f"fused segments {segs}: want a trunk and the "
                           "per-layer head, split further under the budget")
    nz = float((y_ref != 0).float().mean())
    log(f"phase 4: kernel 6 (image form) encoded the input "
        f"{tuple(x.shape)} in 1 launch; ref output {want_shape}, nonzero "
        f"share {nz:.4f}, energy {runs['ref']['m']['energy_uj']!r} "
        "uJ/inference")
    launches["fused_trunk"] = runs["fused"][0]
    launches["ternary_conv2d"] = runs["cuda"][1]
    launches["ternary_conv2d_packed"] = runs["packed"][2]
    boundary, codec_launches = boundary_codec(torch, FT, TC, P, engine, ops,
                                              prog, x, "the CIFAR-10")
    launches.update(codec_launches)
    return {"program": trunk, "compiled": prog, "x": x, "launches": launches,
            "boundary": boundary, "split_budget": split_budget}


def compiled_graphs(compiler) -> dict:
    """benchmarks/backend_parity.py's residual and pad_to programs and
    tests/test_compiler.py's nonconforming graph, from seeded numpy
    arrays: name -> (graph, compile options, input shape)."""
    rng = np.random.default_rng(SEED + 9)
    res = compiler.Graph(in_channels=6, in_hw=(12, 12))
    s = res.conv(_w(rng, (3, 3, 6, 20)), _bn(rng, 20))
    h = res.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    res.add(h, s)
    res.conv(_w(rng, (3, 3, 20, 10)), _bn(rng, 10))
    pad = compiler.Graph(in_channels=5, in_hw=(8, 8))
    pad.conv(_w(rng, (3, 3, 5, 13)), _bn(rng, 13))
    pad.conv(_w(rng, (3, 3, 13, 13)), _bn(rng, 13))
    odd = compiler.Graph(in_channels=6, in_hw=(12, 12))
    odd.conv(_w(rng, (3, 3, 6, 20)), _bn(rng, 20), pool=("max", 2))
    s = odd.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    h = odd.conv(_w(rng, (3, 3, 20, 20)), _bn(rng, 20))
    odd.add(h, s)
    odd.pool("max", 2)
    odd.dense(_w(rng, (3 * 3 * 20, 10)))
    return {"residual": (res, {}, (BATCH, 12, 12, 6)),
            "pad_to": (pad, {"optimize": False, "pad_to": 16},
                       (BATCH, 8, 8, 5)),
            "nonconforming": (odd, {}, (BATCH, 12, 12, 6))}


def compiled_programs(torch, K, FT, P, compiler) -> None:
    """Phase 4 (c): the residual, pad_to and nonconforming programs
    through `CutiePipeline.compile`, on every backend against ``ref``
    (`every_backend`), from seeded input trits."""
    rng = np.random.default_rng(SEED + 10)
    for name, (g, opts, shape) in compiled_graphs(compiler).items():
        pipe = P.CutiePipeline.compile(g, backend="ref", device=DEVICE,
                                       **opts)
        x = torch.as_tensor(rng.integers(-1, 2, shape), dtype=torch.int8,
                            device=DEVICE)
        log(f"phase 4: compiled {name}: layers "
            f"{[tuple(li.weights.shape) for li in pipe.program.layers]}, "
            f"strides {[li.stride for li in pipe.program.layers]}, padding "
            f"{[li.padding for li in pipe.program.layers]}, pools "
            f"{[li.pool for li in pipe.program.layers]}")
        every_backend(torch, K, FT, P, pipe.compile_result, x, None, name)


# -- phase 4: the CNN mesh ------------------------------------------------------

# The mesh path (`mesh_path`): the CIFAR-10 program with its head (phase
# 4's compiled program and its batch-64 input from kernel 6) and a
# full-width uniform trunk (MESH_TRUNK_LAYERS seeded layers 128 -> 128 at
# 32 x 32, batch 64) through `CutiePipeline(mesh=)`, in ranks this script
# starts as processes of its own (``--mesh-rank``), one per mesh position.
# World 1 runs on NCCL; world 4 on gloo with every rank on the one card
# (NCCL refuses two ranks on one device), so the exchanged bytes are
# copied through the host and the compute stays on the card.  Each case:
# (program, mesh, backend, packed collectives, microbatches).
MESH_WORLDS = {1: "nccl", 4: "gloo"}
MESH_CASES = {
    1: [("cifar", "data:1", "cuda", True, None),
        ("cifar", "data:1", "packed", True, None)],
    4: [("cifar", "data:2,filter:2", "cuda", True, None),
        ("cifar", "data:2,filter:2", "packed", True, None),
        ("cifar", "filter:4", "cuda", True, None),
        ("cifar", "filter:4", "cuda", False, None),
        ("cifar", "filter:4", "packed", True, None),
        ("trunk", "layer:4", "cuda", True, 8),
        ("trunk", "layer:4", "cuda", False, 8),
        ("trunk", "layer:4", "packed", True, 8)],
}
MESH_TRUNK_LAYERS, MESH_REPS, MESH_TIMEOUT_S = 8, 3, 300


def _export_program(prog, arrays: dict, name: str) -> dict:
    """A program's arrays into ``arrays`` under ``name/<layer>/<field>``;
    returns its layer metadata and instance."""
    import dataclasses
    layers = []
    for i, li in enumerate(prog.layers):
        arrays[f"{name}/{i}/weights"] = li.weights.cpu().numpy()
        for f in ("t_lo", "t_hi", "flip", "const", "is_const"):
            arrays[f"{name}/{i}/{f}"] = getattr(li.thresholds, f).cpu().numpy()
        layers.append({"stride": list(li.stride), "padding": li.padding,
                       "pool": None if li.pool is None else list(li.pool)})
    return {"layers": layers,
            "instance": dataclasses.asdict(prog.instance)}


def _import_program(convert, z, name: str, meta: dict):
    layers = []
    for i, lm in enumerate(meta["layers"]):
        layer = {f: z[f"{name}/{i}/{f}"] for f in (
            "weights", "t_lo", "t_hi", "flip", "const", "is_const")}
        layer.update(stride=tuple(lm["stride"]), padding=lm["padding"],
                     pool=None if lm["pool"] is None else tuple(lm["pool"]))
        layers.append(layer)
    return convert.program_from_numpy(layers, meta["instance"], device=DEVICE)


def mesh_launches(prog, spec: str, packed: bool, microbatches) -> dict:
    """Kernel launches one rank makes in one meshed run: one conv launch
    per layer (per layer of its stage and ring step on a layer mesh), and
    one pack (kernel 4) and one unpack (kernel 5) per exchange of packed
    activations: per layer between filter shards, per ring step."""
    from repro_torch.launch.cutie_mesh import MeshSpec

    mesh = MeshSpec.parse(spec)
    f, s = mesh.filter, mesh.layer
    n = len(prog.layers)
    if s > 1:
        steps = microbatches + s - 1
        conv, codec = steps * n // s, steps if packed else 0
    else:
        conv, codec = n, n if (f > 1 and packed) else 0
    return {"conv": conv, "pack_trits": codec, "unpack_trits": codec}


def _mesh_world(world: int, backend: str, root: str,
                flag: str = "--mesh-rank") -> list:
    """Start ``world`` ranks of this script (``flag``: ``--mesh-rank`` or
    ``--model-mesh-rank``), wait for all of them, and return each rank's
    results; a rank that fails or outlives MESH_TIMEOUT_S fails the path
    after every rank is stopped."""
    procs = []
    for r in range(world):
        err = open(os.path.join(root, f"w{world}r{r}.err"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag,
             str(r), str(world), backend, root],
            stdout=err, stderr=subprocess.STDOUT), err))
    deadline = time.monotonic() + MESH_TIMEOUT_S + 60
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        with open(os.path.join(root, f"w{world}r{bad[0]}.err")) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"mesh world {world} ({backend}): ranks {bad} "
                           f"failed; rank {bad[0]}'s output:\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(root, f"w{world}r{r}.json")) as f:
            out.append(json.load(f))
    return out


def mesh_path(torch, P, engine, mp, card: str) -> dict:
    """The CNN mesh on the card: each case of MESH_CASES run by every rank
    of its world through `CutiePipeline(mesh=)` must return the unmeshed
    run's trits on the same backend, bit for bit, on every rank, with the
    kernel launches of `mesh_launches` per rank; the unmeshed ``cuda`` and
    ``packed`` runs must agree.  Prints each case's per-rank launches,
    its collective bytes (dense and packed) and its run ms (the slowest
    rank's median; 4 ranks share one card, so it is no scaling figure).
    Returns the launches summed over ranks and the cases."""
    rng = np.random.default_rng(SEED + 11)
    c = CIFAR_WIDTH
    trunk = engine.CutieProgram(
        [engine.compile_layer(torch.as_tensor(_w(rng, (3, 3, c, c)),
                                              device=DEVICE), _bn(rng, c))
         for _ in range(MESH_TRUNK_LAYERS)], engine.CutieInstance())
    xt = torch.as_tensor(rng.integers(-1, 2, (BATCH, CIFAR_HW, CIFAR_HW, c)),
                         dtype=torch.int8, device=DEVICE)
    progs = {"cifar": (mp["compiled"], mp["x"]), "trunk": (trunk, xt)}
    arrays, meta = {}, {}
    for name, (prog, x) in progs.items():
        meta[name] = _export_program(prog, arrays, name)
        arrays[f"{name}/x"] = x.cpu().numpy()
        ys = {be: P.CutiePipeline(prog, backend=be, device=DEVICE).run(x)
              for be in ("cuda", "packed")}
        if not torch.equal(ys["cuda"], ys["packed"]):
            raise RuntimeError(f"mesh path: unmeshed {name} differs between "
                               "cuda and packed")
        for be, y in ys.items():
            arrays[f"{name}/y/{be}"] = y.cpu().numpy()
    totals: dict = {}
    cases = []
    with tempfile.TemporaryDirectory() as root:
        np.savez(os.path.join(root, "mesh.npz"), **arrays)
        with open(os.path.join(root, "mesh.json"), "w") as f:
            json.dump(meta, f)
        for world, backend in MESH_WORLDS.items():
            t0 = time.perf_counter()
            ranks = _mesh_world(world, backend, root)
            wall = time.perf_counter() - t0
            for i, case in enumerate(MESH_CASES[world]):
                name, spec, be, packed, mb = case
                got = [r[i] for r in ranks]
                want = mesh_launches(progs[name][0], spec, packed, mb)
                if DEVICE != "cuda":
                    want = dict.fromkeys(want, 0)
                conv_key = ("ternary_conv2d" if be == "cuda"
                            else "ternary_conv2d_packed")
                for rank, g in enumerate(got):
                    if not g["same"]:
                        raise RuntimeError(
                            f"mesh {spec} {name} on {be} (rank {rank}): "
                            f"output differs from the unmeshed run")
                    seen = {"conv": g["launches"][conv_key],
                            "pack_trits": g["launches"]["pack_trits"],
                            "unpack_trits": g["launches"]["unpack_trits"]}
                    other = [k for k in ("ternary_conv2d",
                                         "ternary_conv2d_packed")
                             if k != conv_key and g["launches"][k]]
                    if seen != want or other or g["launches"]["fused_trunk"]:
                        raise RuntimeError(
                            f"mesh {spec} {name} on {be} (rank {rank}): "
                            f"launches {g['launches']}, want {want}")
                    _add_counts(totals, {k: v for k, v in g["launches"].items()
                                         if k != "thermometer"})
                ms = max(g["ms"] for g in got)
                wire = got[0]["plan"]["wire"]
                nb = got[0]["bytes"]
                log(f"phase 4: mesh {spec} {name} (batch {BATCH}) on {be!r}, "
                    f"{'packed' if packed else 'dense'} collectives over "
                    f"{wire!r} (world {world}, mode "
                    f"{got[0]['plan']['mode']}"
                    + (f", {mb} microbatches, bubble "
                       f"{got[0]['plan']['pipeline']['bubble_fraction']!r}"
                       if mb else "")
                    + f"): every rank's output bit-identical to the unmeshed "
                    f"{be} run; per-rank launches conv {want['conv']}, "
                    f"kernel 4 {want['pack_trits']}, kernel 5 "
                    f"{want['unpack_trits']} (as mesh_launches); collective "
                    f"bytes per rank dense {nb['dense']} packed "
                    f"{nb['packed']} on the wire {nb['on_wire']}"
                    + (f" + layer sum {nb['reduce']}" if "reduce" in nb
                       else "")
                    + f"; run ms (slowest rank's median of {MESH_REPS}, "
                    f"{world} ranks sharing one card, not a scaling figure) "
                    f"{ms!r}; {card}")
                cases.append({"world": world, "case": case, "ms": ms,
                              "bytes": nb, "wire": wire})
            log(f"phase 4: mesh world {world} on {backend}: {len(ranks)} "
                f"ranks, {wall!r} s wall with their start; {card}")
    return {"launches": totals, "cases": cases}


def mesh_rank_main(rank: int, world: int, backend: str, root: str) -> int:
    """``--mesh-rank R WORLD BACKEND DIR``: one rank of the mesh path.
    Joins the process group (``file://DIR/pg<WORLD>``), rebuilds the
    programs of ``DIR/mesh.npz`` on the card, runs its world's cases and
    writes per case the equality with the unmeshed run, the launches of
    one run, the median ms of MESH_REPS more and the collective bytes to
    ``DIR/w<WORLD>r<R>.json``."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import convert
    from repro_torch import pipeline as P
    from repro_torch.kernels import fused_trunk as FT
    from repro_torch.kernels import ternary_conv2d as K
    from repro_torch.kernels import trit_codec as TC

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, f'pg{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        with open(os.path.join(root, "mesh.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(root, "mesh.npz")) as z:
            progs = {name: (_import_program(convert, z, name, m),
                            torch.as_tensor(z[f"{name}/x"], device=DEVICE),
                            {be: torch.as_tensor(z[f"{name}/y/{be}"])
                             for be in ("cuda", "packed")})
                     for name, m in meta.items()}
        out = []
        for name, spec, be, packed, mb in MESH_CASES[world]:
            prog, x, want = progs[name]
            pipe = P.CutiePipeline(prog, backend=be, device=DEVICE, mesh=spec,
                                   packed_collectives=packed,
                                   microbatches=mb)
            reset_launches(K, FT, TC)
            y = pipe.run(x)
            torch.cuda.synchronize()
            launches = _launch_counts(K, FT, TC)
            same = torch.equal(y.cpu(), want[be])
            ts = []
            for _ in range(MESH_REPS):
                dist.barrier()
                t0 = time.perf_counter()
                pipe.run(x)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            plan = pipe.execution_plan()
            out.append({"same": same, "launches": launches,
                        "ms": float(np.median(ts)),
                        "bytes": pipe._sharded.collective_bytes(
                            tuple(x.shape)),
                        "plan": {k: plan.get(k) for k in (
                            "mode", "wire", "collectives", "pipeline")}})
        with open(os.path.join(root, f"w{world}r{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


# The LLM model mesh (`model_mesh_path`): ranks this script starts as
# processes of its own (``--model-mesh-rank``), world 1 on NCCL, world 4 on
# gloo with every rank on the one card (exchanges staged through the
# host).  The decode cell: the main path's llama3.2-1B ternary_packed
# (full width and depth, the same seeded weights) prefills the 8 prompts
# through `steps.make_prefill_step` and `prefill_with_cache` into a
# MODEL_MESH_MAX_LEN cache, then runs MODEL_MESH_STEPS steps of
# `steps.build_cell`'s decode step, fed the unmeshed greedy tokens: bit
# for bit on data:1,model:1; on data:2,model:2 and model:4 every logit
# within MODEL_MESH_ULPS bf16 ulps of its row's largest |logit| of the
# unmeshed run (measured on an H100 80GB HBM3 at 700 W: at most 2.5 and
# 1.75; the row-parallel products round their partial sums to bf16 before
# the all-reduce), and the greedy tokens the unmeshed ones wherever its
# top-2 margin exceeds that tolerance; kernel 7 launches 7 x 16 per
# forward per rank.  After the counted run every rank runs one prefill
# and one decode step of its cell inside `kernel_vs_plain`: each of
# kernel 7's calls (its slices: N/tp columns, packed rows cut 205 | 205
# at model:2, or the whole leaf behind an all-gather) within
# SSM_MIXER_ULPS of its plain version on the same input, at exactly the
# (M, K, N) that `mm_slice_shapes` works out from the rank's slices.  The
# train cell: llama3.2-1B QAT at full width and MODEL_MESH_TRAIN_LAYERS
# layers, batch TRAIN_BATCH, seq TRAIN_SEQ, on data:2,model:2 for
# MODEL_MESH_TRAIN_STEPS steps: the loss within MODEL_MESH_LOSS_ATOL and
# the grad norm within MODEL_MESH_GN_RTOL of the unmeshed steps', and the
# gathered params after the last step against the unmeshed step's, leaf
# by leaf: every entry within twice the summed learning rates plus a
# bf16 ulp of the leaf's largest |value| (Adam's first updates are
# lr * sign(g), and an entry of g within rounding of 0 may take the other
# sign), and at most MODEL_MESH_PARAM_SHARE of a leaf's entries further
# apart than the largest lr plus a bf16 ulp (entries whose updates went
# other ways); then a checkpoint saved on that mesh restores onto model:4
# and data:4 bit for bit.  The EP cell: one qwen3-moe-30b-a3b MoE
# layer at full width (128 experts, 1.2 GB of bf16 experts), capacity
# factor 8, moe_impl="ep" on model:4 against the dense dispatch on every
# rank, at tests/test_moe_ep.py's tolerances (rtol 2e-2 / atol 2e-3, the
# gradients' relative L2 error below 2e-2, lb_loss rtol 0.1), y's rtol
# taken of its largest |value|: the seeded experts give rows of |y| up to
# about a hundred, each a bf16 sum of 8 gated rows that the dense dispatch
# adds in one order and EP in four partial sums and an all-reduce, so an
# entry that cancels to near 0 differs by up to a bf16 ulp of its terms
# (0.5 at a largest |y| of about a hundred on an H100 80GB HBM3 at 700 W).
MODEL_MESH_WORLDS = {1: "nccl", 4: "gloo"}
MODEL_MESH_DECODE = {1: ("data:1,model:1",),
                     4: ("data:2,model:2", "model:4")}
MODEL_MESH_STEPS, MODEL_MESH_MAX_LEN, MODEL_MESH_ULPS = 8, 64, 4
MODEL_MESH_TRAIN_LAYERS, MODEL_MESH_TRAIN_STEPS = 4, 2
# the train cell's losses and grad norms against the unmeshed steps'
# (measured on an H100 80GB HBM3 at 700 W: within 2.3e-3 and 4.1e-4
# relative; the meshed gradients are summed in other orders and round
# partial products to bf16: 0.4-2% relative L2 per leaf at step 1, a
# sign taken the other way at up to 1% of the entries, where the two
# unmeshed runs on the card are bit-identical)
MODEL_MESH_LOSS_ATOL, MODEL_MESH_GN_RTOL = 2.0 ** -6, 2.0 ** -8
# tests/test_torch_model_mesh.py's REF_STEP_SHARE
MODEL_MESH_PARAM_SHARE = 0.01
MODEL_MESH_RESTORES = ("model:4", "data:4")
MODEL_MESH_EP_TOKENS, MODEL_MESH_EP_CAPACITY = (4, 64), 8.0
# the decode cell whose step the dry run predicts (`launch.dryrun`)
MODEL_MESH_DRYRUN = "model:4"


def _ulp_rows(torch, rows):
    """A bf16 ulp of each row's largest |value| (last axis)."""
    m = rows.float().abs().amax(dim=-1, keepdim=True).clamp(min=1e-30)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def _digest(torch, tree) -> float:
    """A float64 sum over every leaf of a tree (dicts and lists)."""
    from repro_torch.train.loop import _leaves

    return float(sum(t.double().sum() for t in _leaves(tree)))


def _mm_train_cfg():
    from repro_torch import configs

    return configs.get(LLM_ARCH).replace(quant="ternary",
                                         n_layers=MODEL_MESH_TRAIN_LAYERS)


def _mm_train_params(torch, TF):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 27)
    return TF.init_params(_mm_train_cfg(), gen)


def _mm_adam():
    from repro_torch.optim import adam

    return adam.AdamConfig(total_steps=4, warmup_steps=1)


def _mm_batch(torch, step: int) -> dict:
    rng = np.random.default_rng(SEED + 28 + step)
    vocab = _mm_train_cfg().vocab
    return {k: torch.as_tensor(rng.integers(0, vocab, (TRAIN_BATCH,
                                                        TRAIN_SEQ)),
                               device=DEVICE) for k in ("tokens", "labels")}


def _mm_unmeshed_decode(torch, TF, DEC, params, cfg, tokens, fed):
    """The unmeshed decode cell: the prefill's last logits, then one row
    per step fed ``fed`` (or its own greedy tokens when None); returns
    (logits (steps + 1, B, 1, V), tokens fed (steps, B, 1))."""
    b = tokens.shape[0]
    with torch.no_grad():
        rows = [TF.forward_logits(params, {"tokens": tokens}, cfg)]
        _, caches = DEC.prefill_with_cache(params, {"tokens": tokens}, cfg,
                                           MODEL_MESH_MAX_LEN)
        toks = []
        for i in range(MODEL_MESH_STEPS):
            tok = rows[-1].argmax(-1) if fed is None else fed[i]
            toks.append(tok)
            pos = torch.full((b,), tokens.shape[1] + i, device=DEVICE)
            lg, caches = DEC.decode_step(params, tok, caches, pos, cfg)
            rows.append(lg)
    return torch.stack(rows), torch.stack(toks)


def model_mesh_path(torch, MM, TF, DEC, llm, card: str) -> int:
    """The LLM model mesh on the card (see MODEL_MESH_*): this process
    runs the unmeshed decode cell and train steps, the ranks the meshed
    ones and the EP cell.  Prints each cell's checks, ms per step (the
    slowest rank's median) and collective bytes per rank.  Returns the
    kernel-7 launches summed over every rank's decode cells."""
    from repro_torch.launch import steps as ST

    cfg, params = llm["cfg"], llm["params"]
    tokens = torch.as_tensor(np.stack(llm["prompts"]), device=DEVICE)
    logits, fed = _mm_unmeshed_decode(torch, TF, DEC, params, cfg, tokens,
                                      None)
    tparams = _mm_train_params(torch, TF)
    step = ST.make_train_step(_mm_train_cfg(), _mm_adam())
    from repro_torch.optim import adam
    from repro_torch.train.loop import _leaves
    opt = adam.init_state(_leaves(tparams))
    train = {"loss": [], "grad_norm": [], "lr": [], "ms": [],
             "digest": _digest(torch, tparams)}
    for i in range(MODEL_MESH_TRAIN_STEPS):
        sync(torch)
        t0 = time.perf_counter()
        tparams, opt, m = step(tparams, opt, _mm_batch(torch, i))
        sync(torch)
        train["ms"].append((time.perf_counter() - t0) * 1e3)
        train["loss"].append(float(m["loss"]))
        train["grad_norm"].append(float(m["grad_norm"]))
        train["lr"].append(float(m["lr"]))
    after = [t.cpu() for t in _leaves(tparams)]
    del tparams, opt, m
    torch.cuda.empty_cache()
    log(f"phase 4: model mesh: unmeshed train steps ({_mm_train_cfg().name} "
        f"QAT, {MODEL_MESH_TRAIN_LAYERS} layers, batch {TRAIN_BATCH}, seq "
        f"{TRAIN_SEQ}): losses {train['loss']!r} grad norms "
        f"{train['grad_norm']!r} ms {train['ms']!r}; {card}")
    total = 0
    with tempfile.TemporaryDirectory() as root:
        np.savez(os.path.join(root, "model_mesh.npz"),
                 logits=logits.float().cpu().numpy(),
                 fed=fed.cpu().numpy(), prompts=tokens.cpu().numpy())
        with open(os.path.join(root, "model_mesh.json"), "w") as f:
            json.dump({"train": train, "digest": _digest(torch, params)}, f)
        torch.save(after, os.path.join(root, "model_mesh_train.pt"))
        del logits, after
        for world, backend in MODEL_MESH_WORLDS.items():
            t0 = time.perf_counter()
            ranks = _mesh_world(world, backend, root, "--model-mesh-rank")
            wall = time.perf_counter() - t0
            total += _model_mesh_report(ranks, world, backend, train, cfg,
                                        card)
            log(f"phase 4: model mesh world {world} on {backend}: "
                f"{len(ranks)} ranks, {wall!r} s wall with their start; "
                f"{card}")
    return total


def _model_mesh_report(ranks, world, backend, train, cfg, card) -> int:
    """Check and print one world's results; its kernel-7 launches."""
    launches = 0
    for i, spec in enumerate(MODEL_MESH_DECODE[world]):
        got = [r["decode"][i] for r in ranks]
        for rank, g in enumerate(got):
            what = f"model mesh {spec} (rank {rank})"
            if g["launches"] != g["want"]:
                raise RuntimeError(f"{what}: kernel 7 launched "
                                   f"{g['launches']}, want {g['want']}")
            if world == 1 and not g["bitwise"]:
                raise RuntimeError(f"{what}: logits differ from the unmeshed "
                                   "run's")
            if g["max_ulps"] > MODEL_MESH_ULPS:
                raise RuntimeError(f"{what}: a logit {g['max_ulps']} ulps "
                                   "from the unmeshed run's")
            if any(m > MODEL_MESH_ULPS for m in g["token_diffs"]):
                raise RuntimeError(f"{what}: greedy tokens differ at top-2 "
                                   f"margins {g['token_diffs']} ulps")
            if g["cache_len"] != MODEL_MESH_MAX_LEN // g["tp"]:
                raise RuntimeError(f"{what}: the cache holds "
                                   f"{g['cache_len']} positions per rank")
            if sorted(g["vs_plain"]) != sorted(g["slice_shapes"]) or \
                    max(g["vs_plain"].values()) > SSM_MIXER_ULPS:
                raise RuntimeError(f"{what}: kernel 7 against its plain "
                                   f"version (M, K, N) -> ulps "
                                   f"{g['vs_plain']}, want the shapes "
                                   f"{g['slice_shapes']} within "
                                   f"{SSM_MIXER_ULPS}")
            d = g["dryrun"]
            if spec == MODEL_MESH_DRYRUN and (
                    not d["records_equal"]
                    or d["arg_bytes"] != d["dry_arg_bytes"]):
                raise RuntimeError(f"{what}: the dry run's decode step "
                                   f"differs from the run's: {d}")
            launches += g["launches"]
        vs_plain: dict = {}
        for g in got:
            for k, v in g["vs_plain"].items():
                vs_plain[k] = max(vs_plain.get(k, 0.0), v)
        g = got[0]
        ms = max(r["ms"] for r in got)
        log(f"phase 4: model mesh decode cell {spec} ({cfg.name} "
            f"ternary_packed, {LLM_REQUESTS} prompts x {LLM_PROMPT} tokens, "
            f"{MODEL_MESH_STEPS} decode steps, cache {MODEL_MESH_MAX_LEN} "
            f"with {g['cache_len']} positions per rank; {backend}): "
            + ("every logit bit-identical to the unmeshed run; "
               if world == 1 else
               f"largest logit difference {max(r['max_ulps'] for r in got)!r}"
               f" bf16 ulps of its row's max |logit| (at most "
               f"{MODEL_MESH_ULPS}; abs {max(r['max_abs'] for r in got)!r}); ")
            + f"greedy tokens {g['tokens_equal']} of {g['tokens_total']} "
            f"equal, differences at top-2 margins {g['token_diffs']}; kernel "
            f"7 launched {g['launches']} times per rank (7 x {cfg.n_layers} "
            f"x {2 + MODEL_MESH_STEPS} forwards); decode step ms (slowest "
            f"rank's median) {ms!r}, prefill ms {max(r['prefill_ms'] for r in got)!r}"
            f"; collective bytes per rank per decode step "
            f"{g['bytes_per_step']}; {world} ranks on one card; {card}")
        log(f"phase 4: model mesh decode cell {spec}: kernel 7 against its "
            f"plain version on the same input in one prefill and one decode "
            f"step, max |err| in bf16 ulps of the row's largest |output| "
            f"per (M, K, N) over every rank: "
            f"{ {k: round(v, 3) for k, v in sorted(vs_plain.items())} } "
            f"(tolerance {SSM_MIXER_ULPS}); {card}")
        if spec == MODEL_MESH_DRYRUN:
            d = g["dryrun"]
            log(f"phase 4: model mesh decode cell {spec}: the dry run "
                f"(`launch.dryrun`, a meta walk on a stand-in mesh) against "
                f"one decode step walked on every rank: exchanges equal op "
                f"for op ({d['records']} records, "
                f"{d['wire']!r} wire bytes per rank), argument bytes "
                f"{d['dry_arg_bytes']} = the rank's local bytes "
                f"{d['arg_bytes']}, FLOPs {d['dry_flops']!r} (run "
                f"{d['flops']!r}); dry-run memory per rank {d['memory']}; "
                f"{card}")
    if world == 1:
        return launches
    t = [r["train"] for r in ranks]
    for rank, r in enumerate(t):
        if not np.allclose(r["loss"], train["loss"], rtol=0,
                           atol=MODEL_MESH_LOSS_ATOL) or not np.allclose(
                r["grad_norm"], train["grad_norm"], rtol=MODEL_MESH_GN_RTOL):
            raise RuntimeError(f"model mesh train (rank {rank}): losses "
                               f"{r['loss']} grad norms {r['grad_norm']}, "
                               f"unmeshed {train['loss']} "
                               f"{train['grad_norm']}")
        if not all(r["restored"].values()):
            raise RuntimeError(f"model mesh train (rank {rank}): restores "
                               f"{r['restored']} not all bit-identical")
    r = t[0]
    if not r["param_share"] or r["param_over"] or \
            max(r["param_share"]) > MODEL_MESH_PARAM_SHARE:
        raise RuntimeError(f"model mesh train: params after step "
                           f"{MODEL_MESH_TRAIN_STEPS} vs the unmeshed "
                           f"step's: leaves {r['param_over']} past their "
                           f"bound, shares beyond the largest lr + one ulp "
                           f"{r['param_share']}")
    e = [r["ep"] for r in ranks]
    for rank, r in enumerate(e):
        if not r["y_close"] or abs(r["lb"] - r["lb_dense"]) > \
                0.1 * abs(r["lb_dense"]) or max(r["grad_rel"].values()) >= 2e-2:
            raise RuntimeError(f"model mesh EP (rank {rank}): {r}")
    log(f"phase 4: model mesh train cell data:2,model:2 ({_mm_train_cfg().name}"
        f" QAT, {MODEL_MESH_TRAIN_LAYERS} layers, batch {TRAIN_BATCH}, seq "
        f"{TRAIN_SEQ}, ZeRO-1 moments): losses {t[0]['loss']!r} (unmeshed "
        f"{train['loss']!r}, within {MODEL_MESH_LOSS_ATOL}), grad norms "
        f"{t[0]['grad_norm']!r} (unmeshed {train['grad_norm']!r}, rtol "
        f"{MODEL_MESH_GN_RTOL}); params after step {MODEL_MESH_TRAIN_STEPS} "
        f"against the unmeshed step's: largest |diff| over the leaves "
        f"{max(t[0]['param_max_abs'])!r} (each leaf's bound 2 x the summed "
        f"lr {sum(train['lr'])!r} + a bf16 ulp of its largest |value|), "
        f"largest share of a leaf's entries beyond the largest lr + one ulp"
        f" {max(t[0]['param_share'])!r} (at most {MODEL_MESH_PARAM_SHARE}; "
        f"beyond one ulp {max(t[0]['param_ulp_share'])!r}); "
        f"step ms (slowest rank's median) "
        f"{max(float(np.median(r['ms'])) for r in t)!r}; collective bytes "
        f"per rank per step {t[0]['bytes_per_step']}; checkpoint save "
        f"{t[0]['save_s']!r} s ({t[0]['ckpt_bytes']} B on disk), restores "
        f"bit-identical onto {', '.join(MODEL_MESH_RESTORES)} in "
        f"{t[0]['restore_s']!r} s; {card}")
    log(f"phase 4: model mesh EP cell model:4 (qwen3-moe-30b-a3b MoE layer, "
        f"{e[0]['experts_local']} of 128 experts per rank, "
        f"{MODEL_MESH_EP_TOKENS[0]} x {MODEL_MESH_EP_TOKENS[1]} tokens, "
        f"capacity factor {MODEL_MESH_EP_CAPACITY}): y within rtol 2e-2 of "
        f"the largest |y| ({e[0]['y_top']!r}) + atol 2e-3 of the dense "
        f"dispatch (max abs {max(r['y_max_abs'] for r in e)!r}, relative "
        f"L2 {max(r['y_rel_l2'] for r in e)!r}), lb_loss {e[0]['lb']!r} vs "
        f"{e[0]['lb_dense']!r}, gradients' relative L2 error at most "
        f"{max(max(r['grad_rel'].values()) for r in e)!r}; forward ms "
        f"(slowest rank's median) ep {max(r['ep_ms'] for r in e)!r}, dense "
        f"{max(r['dense_ms'] for r in e)!r}; collective bytes per rank per "
        f"forward {e[0]['bytes']}; {card}")
    return launches


def _mm_decode_cell(torch, MM, TF, DEC, M, SH, ST, C, cfg, params, z,
                    spec: str, world: int) -> dict:
    """One rank's meshed decode cell on ``spec`` (see MODEL_MESH_*)."""
    from repro_torch.models.config import ShapeSpec

    tokens = torch.as_tensor(z["prompts"], device=DEVICE)
    want = torch.as_tensor(z["logits"], device=DEVICE)
    fed = torch.as_tensor(z["fed"], device=DEVICE)
    b, s = tokens.shape
    own = None
    if world == 1:        # the bit-for-bit check: this process, unmeshed
        own, _ = _mm_unmeshed_decode(torch, TF, DEC, params, cfg, tokens,
                                     fed)
    mesh = M.make_mesh(*M.parse(spec), device=DEVICE)
    fn, _, sp = ST.build_cell(cfg, ShapeSpec("d", MODEL_MESH_MAX_LEN, b,
                                             "decode"), mesh)
    pf, _, psp = ST.build_cell(cfg, ShapeSpec("p", s, b, "prefill"), mesh)
    pspecs, tok_spec, _, pos_spec = sp["in"]
    local = SH.shard_tree(params, pspecs, mesh)
    lb = {"tokens": SH.shard_leaf(tokens, psp["in"][1]["tokens"], mesh)}
    sync(torch)
    mesh.barrier()
    reset_launches(MM)
    with torch.no_grad():
        t0 = time.perf_counter()
        first = pf(local, lb)
        with C.use_mesh(mesh):
            _, caches = DEC.prefill_with_cache(local, lb, cfg,
                                               MODEL_MESH_MAX_LEN)
        sync(torch)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        rows = [first]
        ts, nbytes = [], []
        for i in range(MODEL_MESH_STEPS):
            pos = torch.full((b,), s + i, device=DEVICE)
            tok, pos = (SH.shard_leaf(fed[i], tok_spec, mesh),
                        SH.shard_leaf(pos, pos_spec, mesh))
            sent = sum(mesh.sent.values())
            sync(torch)
            t0 = time.perf_counter()
            lg, caches = fn(local, tok, caches, pos)
            sync(torch)
            ts.append((time.perf_counter() - t0) * 1e3)
            nbytes.append(sum(mesh.sent.values()) - sent)
            rows.append(lg)
        launches = MM.LAUNCHES["ternary_matmul"]
        got = torch.stack([SH.gather_leaf(r, sp["out"][0], mesh)
                           for r in rows])
        with kernel_vs_plain(torch, MM, C) as vs_plain:
            with C.use_mesh(mesh):
                _, again = DEC.prefill_with_cache(local, lb, cfg,
                                                  MODEL_MESH_MAX_LEN)
            pos = torch.full((b,), s, device=DEVICE)
            fn(local, SH.shard_leaf(fed[0], tok_spec, mesh), again,
               SH.shard_leaf(pos, pos_spec, mesh))
        del again
        dry = None
        if spec == MODEL_MESH_DRYRUN:
            # one more step, walked, with the dry run's int32 token and pos
            pos = torch.full((b,), s + MODEL_MESH_STEPS, dtype=torch.int32,
                             device=DEVICE)
            dry = _mm_dryrun(torch, M, ST, cfg, fn, (
                local, SH.shard_leaf(fed[-1].to(torch.int32), tok_spec, mesh),
                caches, SH.shard_leaf(pos, pos_spec, mesh)), mesh, b)
    bl = lb["tokens"].shape[0]                   # this rank's batch rows
    diff = (got.float() - want.float()).abs()
    ulps = diff / _ulp_rows(torch, want)
    top2 = want.float().topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / _ulp_rows(torch, want)[..., 0]
    g_tok, w_tok = got.argmax(-1), want.argmax(-1)
    return {"spec": spec, "launches": launches,
            "bitwise": own is not None and torch.equal(got, own),
            "cache_len": int(caches["kv"]["k"].shape[2]),
            "tp": mesh.axis_size("model"),
            "want": (7 * cfg.n_layers * (2 + MODEL_MESH_STEPS)
                     if DEVICE == "cuda" else 0),
            "ms": float(np.median(ts)), "prefill_ms": prefill_ms,
            "max_ulps": float(ulps.max()), "max_abs": float(diff.max()),
            "tokens_equal": int((g_tok == w_tok).sum()),
            "tokens_total": int(w_tok.numel()),
            "token_diffs": margin[g_tok != w_tok].tolist(),
            "bytes_per_step": int(np.median(nbytes)),
            "vs_plain": {str(k): v for k, v in vs_plain.items()},
            "slice_shapes": [str((m, k, n)) for m in (bl * s, bl)
                             for k, n in mm_slice_shapes(cfg, local, mesh)],
            "dryrun": dry}


def _mm_dryrun(torch, M, ST, cfg, fn, args, mesh, b) -> dict:
    """A decode step of the cell walked for real (`hlo.walk`: its
    exchanges, argument bytes and FLOPs) beside the dry run's walk of
    the same cell on ``meta`` tensors on a `StandInMesh` at this rank's
    coordinates (`dryrun.local_args`)."""
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeSpec
    from repro_torch.roofline import hlo

    w = hlo.walk(fn, args, mesh)
    stand = M.StandInMesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                          mesh.axis_names,
                          coord={a: mesh.coord(a) for a in mesh.axis_names})
    mw = hlo.walk(*dryrun.local_args(cfg, ShapeSpec(
        "d", MODEL_MESH_MAX_LEN, b, "decode"), stand), stand)
    return {"records_equal": list(w.records) == list(mw.records),
            "records": len(w.records), "arg_bytes": w.argument_bytes,
            "dry_arg_bytes": mw.argument_bytes, "flops": w.flops,
            "dry_flops": mw.flops,
            "wire": hlo.collective_bytes(mw.records)["total_wire_bytes"],
            "memory": hlo.memory(mw)}


def mm_slice_shapes(cfg, local, mesh) -> list:
    """The (K, N) at which kernel 7 runs on this rank's slices of a
    packed layer: N/tp columns of a column-sharded leaf; for a leaf whose
    packed rows are cut over ``model``, the K range [5r c, min(K,
    5r (c + 1))) of its r byte rows at model coordinate c; K whole for
    a replicated leaf (its input all-gathered)."""
    d, q, kv, f = (cfg.d_model, cfg.n_heads * cfg.d_head,
                   cfg.n_kv * cfg.d_head, cfg.d_ff)
    lp, c = local["layers"][0], mesh.coord("model")
    out = set()
    for grp, name, k in (("attn", "wq", d), ("attn", "wk", d),
                         ("attn", "wv", d), ("attn", "wo", q),
                         ("mlp", "gate", d), ("mlp", "up", d),
                         ("mlp", "down", f)):
        r, n = lp[grp][name]["w_packed"].shape
        if r != -(-k // 5):
            k = min(k, 5 * r * (c + 1)) - 5 * r * c
        out.add((k, n))
    return sorted(out)


def _mm_train_cell(torch, TF, M, SH, ST, root: str, train: dict) -> dict:
    """One rank's train cell on data:2,model:2, its checkpoint and the
    restores (see MODEL_MESH_*)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.data.pipeline import make_global
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam
    from repro_torch.train.loop import _leaves

    params = _mm_train_params(torch, TF)
    if _digest(torch, params) != train["digest"]:
        raise RuntimeError("model mesh train: the rank drew other weights")
    mesh = M.make_mesh((2, 2), ("data", "model"), device=DEVICE)
    fn, _, sp = ST.build_cell(_mm_train_cfg(), ShapeSpec(
        "t", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh, _mm_adam())
    local = SH.shard_tree(params, sp["in"][0], mesh)
    del params
    opt = adam.init_state(_leaves(local), sp["placement"])
    out = {"loss": [], "grad_norm": [], "ms": [], "bytes_per_step": 0}
    for i in range(MODEL_MESH_TRAIN_STEPS):
        batch = make_global(_mm_batch(torch, i), mesh, sp["in"][2])
        sync(torch)
        mesh.barrier()
        sent = sum(mesh.sent.values())
        t0 = time.perf_counter()
        local, opt, m = fn(local, opt, batch)
        sync(torch)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["bytes_per_step"] = sum(mesh.sent.values()) - sent
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    del opt
    full = SH.gather_tree(local, sp["in"][0], mesh)
    bound = 2 * sum(train["lr"])
    out.update(param_max_abs=[], param_share=[], param_ulp_share=[],
               param_over=[])
    # every rank gathered the same tree: rank 0 holds it to the unmeshed
    unmeshed = torch.load(os.path.join(root, "model_mesh_train.pt")) \
        if mesh.rank == 0 else []
    for i, (a, w) in enumerate(zip(_leaves(full) if unmeshed else [],
                                   unmeshed, strict=True)):
        if a.shape != w.shape:
            raise RuntimeError(f"model mesh train: leaf {i} gathered as "
                               f"{tuple(a.shape)}, unmeshed {tuple(w.shape)}")
        w = w.to(DEVICE).float()
        diff = (a.float() - w).abs()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(
            2.0 ** -126))) - 7)
        out["param_max_abs"].append(float(diff.max()))
        out["param_ulp_share"].append(float((diff > ulp).float().mean()))
        out["param_share"].append(float((diff > ulp + max(train["lr"]))
                                        .float().mean()))
        if float(diff.max()) > bound + float(ulp.max()):
            out["param_over"].append(i)
        del w, diff, ulp
    d = os.path.join(root, "ckpt")
    t0 = time.perf_counter()
    ckpt.save(d, MODEL_MESH_TRAIN_STEPS, {"params": local}, mesh=mesh,
              pspecs={"params": sp["in"][0]})
    out["save_s"] = time.perf_counter() - t0
    out["ckpt_bytes"] = sum(os.path.getsize(os.path.join(w, f))
                            for w, _, fs in os.walk(d) for f in fs)
    del local
    t0 = time.perf_counter()
    out["restored"] = {}
    for spec in MODEL_MESH_RESTORES:
        m2 = M.make_mesh(*M.parse(spec), device=DEVICE)
        specs = {"params": SH.param_specs(full, m2)}
        want = SH.shard_tree({"params": full}, specs, m2)
        got, man = ckpt.restore(d, want, mesh=m2, pspecs=specs)
        out["restored"][spec] = man["step"] == MODEL_MESH_TRAIN_STEPS and all(
            torch.equal(a, b) and a.dtype == b.dtype
            for a, b in zip(_leaves(got), _leaves(want)))
        del got, want
    out["restore_s"] = time.perf_counter() - t0
    return out


def _mm_ep_cell(torch, M, SH, C) -> dict:
    """One rank's EP cell on model:4 against the dense dispatch of the
    whole layer in the same process (see MODEL_MESH_*)."""
    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.optim import adam

    cfg = configs.get("qwen3-moe-30b-a3b").replace(
        capacity_factor=MODEL_MESH_EP_CAPACITY)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 29)
    p = moe.init(gen, cfg)
    x = torch.randn((*MODEL_MESH_EP_TOKENS, cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    keys = sorted(p)

    def run(leaves, impl):
        y, aux = moe.apply(leaves, x, cfg.replace(moe_impl=impl))
        g = torch.autograd.grad((y.float() ** 2).sum(),
                                [leaves[k] for k in keys])
        return y.detach(), aux, g

    dense = {k: p[k].clone().requires_grad_(True) for k in keys}
    y_d, aux_d, g_d = run(dense, "dense")
    mesh = M.make_mesh((4,), ("model",), device=DEVICE)
    specs = SH.param_specs({"moe": p}, mesh)["moe"]
    local = {k: SH.shard_leaf(p[k], specs[k], mesh).contiguous()
             .requires_grad_(True) for k in keys}
    with C.use_mesh(mesh):
        sent = sum(mesh.sent.values())
        y_e, aux_e, g_e = run(local, "ep")
        nbytes = sum(mesh.sent.values()) - sent
    placement = adam.Placement(mesh, tuple(specs[k] for k in keys),
                               tuple(specs[k] for k in keys))
    g_e = adam.reduce_grads(list(g_e), placement)
    diff = (y_e.float() - y_d.float()).abs()
    rel = {}
    for k, ge, gd in zip(keys, g_e, g_d):
        gd = SH.shard_leaf(gd, specs[k], mesh)
        rel[k] = float((ge.float() - gd.float()).norm()
                       / gd.float().norm().clamp(min=1e-9))
    times = {}
    for impl, leaves in (("ep", local), ("dense", dense)):
        ts = []
        for _ in range(4):
            sync(torch)
            mesh.barrier()
            t0 = time.perf_counter()
            with torch.no_grad(), C.use_mesh(mesh if impl == "ep" else None):
                moe.apply(leaves, x, cfg.replace(moe_impl=impl))
            sync(torch)
            ts.append((time.perf_counter() - t0) * 1e3)
        times[impl] = float(np.median(ts[1:]))
    top = float(y_d.float().abs().max())
    return {"experts_local": int(local["gate_proj"].shape[0]),
            "y_max_abs": float(diff.max()), "y_top": top,
            "y_rel_l2": float((y_e.float() - y_d.float()).norm()
                              / y_d.float().norm()),
            "y_close": float(diff.max()) <= 2e-3 + 2e-2 * top,
            "lb": float(aux_e["lb_loss"]), "lb_dense": float(aux_d["lb_loss"]),
            "grad_rel": rel, "ep_ms": times["ep"], "dense_ms": times["dense"],
            "bytes": nbytes}


def model_mesh_rank_main(rank: int, world: int, backend: str,
                         root: str) -> int:
    """``--model-mesh-rank R WORLD BACKEND DIR``: one rank of the model
    mesh path.  Joins the process group (``file://DIR/mpg<WORLD>``),
    draws the main path's llama3.2-1B weights (their digest must be the
    parent's), runs its world's decode cells, and in the world of 4 the
    train cell and the EP cell, and writes its results to
    ``DIR/w<WORLD>r<R>.json``; any failed check raises."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import common as C
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, f'mpg{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        with open(os.path.join(root, "model_mesh.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(root, "model_mesh.npz")) as z:
            z = {k: z[k] for k in z.files}
        cfg = configs.get(LLM_ARCH).replace(quant="ternary_packed",
                                            attn_kv_chunk=16)
        params = llm_params(torch, TF, cfg)
        if _digest(torch, params) != meta["digest"]:
            raise RuntimeError("model mesh: the rank drew other weights")
        out = {"decode": [_mm_decode_cell(torch, MM, TF, DEC, M, SH, ST, C,
                                          cfg, params, z, spec, world)
                          for spec in MODEL_MESH_DECODE[world]]}
        del params, z
        torch.cuda.empty_cache()
        if world > 1:
            out["train"] = _mm_train_cell(torch, TF, M, SH, ST, root,
                                          meta["train"])
            torch.cuda.empty_cache()
            out["ep"] = _mm_ep_cell(torch, M, SH, C)
        with open(os.path.join(root, f"w{world}r{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


# -- phase 4: GPipe over pod and the ssm, hybrid and encdec families on a
# model axis (the last slice) ------------------------------------------------

# Ranks are processes of this script (``--gpipe-tp-rank``): world 1 on
# NCCL, worlds 2 and 4 on gloo with every rank on the one card.  Every
# meshed run is held to the same unmeshed run on the card (this
# process): the pipelined loss and the last stage's final hidden rows
# (the input of `losses.chunked_xent`) bit for bit on pod:2, within
# GPIPE_LOSS_ATOL and GPIPE_HIDDEN_ULPS on pod:2,model:2; each family's
# logits within its cell's FAMILY_MESH_ULPS (bit for bit on
# data:1,model:1); kernel 7 against its plain version per sliced shape
# within SSM_MIXER_ULPS.  Depths are cut (PERF.md section 4): each
# gloo exchange is host-staged (about 3 ms), and a decode step of a
# family on a model axis makes several per layer.
GPIPE_TP_WORLDS = {1: "nccl", 2: "gloo", 4: "gloo"}
GPIPE_MESHES = {2: "pod:2", 4: "pod:2,model:2"}
GPIPE_MICRO = 4
FAMILY_CELLS = {1: (("ssm", "data:1,model:1"),),
                2: (("ssm", "model:2"), ("hybrid", "model:2"),
                    ("encdec", "model:2")),
                4: (("hybrid", "model:4"),)}
FAMILY_SSM_LAYERS, FAMILY_ENCDEC_LAYERS = 8, 4
FAMILY_BATCH = {"ssm": 8, "hybrid": HYBRID_BATCH, "encdec": 1}
FAMILY_PROMPT = {"ssm": 16, "hybrid": 16, "encdec": ENCDEC_PROMPT}
FAMILY_STEPS, FAMILY_MAX_LEN = 4, 32
# a family cell's logits in bf16 ulps of each row's largest |logit|,
# per cell: (against the unmeshed run; against the unmeshed run with the
# row-cut projections' bf16 partial sums, `row_partials`, its prefill
# row; the same, its decode rows), each twice its reading on an H100
# 80GB HBM3 at 700 W, rounded up.  A model axis rounds
# each row-cut projection's bf16 partial sums (on the CPU the meshed run
# equals the `row_partials` run bit for bit), and the SSM stack
# amplifies that rounding (the ssm family's end-to-end correlation is
# held at SSM_CORR, not 0.99, for the same reason): zamba2 on model:2
# reads 15.06 ulps from the unmeshed run, its decode rows 0 from the
# `row_partials` run (its prefill row 5.25: the SSD's einsums on head
# slices).  On model:4 kernel 7's column slices also take another K
# split (the kernel's plan follows N), so the `row_partials` run is no
# closer there (20.5).  mamba2's out_proj (615 packed rows) and
# whisper's row products at model:2 read 2.75 and 2.5 at most.
FAMILY_MESH_ULPS = {"ssm model:2": (6, 3, 6),
                    "hybrid model:2": (31, 11, 0),
                    "encdec model:2": (5, 5, 5),
                    "hybrid model:4": (33, 16, 41)}
# the pipelined loss on pod:2,model:2 against the unmeshed one (read
# 4.3e-4 on an H100 80GB HBM3 at 700 W; the CPU's
# reduced model 1.2e-3), and its last stage's final hidden rows in bf16
# ulps of each row's largest |value|, twice the 7.0 read there
GPIPE_LOSS_ATOL, GPIPE_HIDDEN_ULPS = 2e-3, 14


def family_cfg(configs, fam: str):
    """The depth-cut ``ternary_packed`` config of a family's cell:
    mamba2-780m at FAMILY_SSM_LAYERS of 48 layers, zamba2-2.7b at one
    ``attn_every`` period (6 mamba2 layers and the shared block),
    whisper-medium at FAMILY_ENCDEC_LAYERS encoder and decoder layers."""
    if fam == "ssm":
        return configs.get(SSM_ARCH).replace(quant="ternary_packed",
                                            n_layers=FAMILY_SSM_LAYERS)
    if fam == "hybrid":
        cfg = configs.get(HYBRID_ARCH)
        return cfg.replace(quant="ternary_packed", n_layers=cfg.attn_every)
    return configs.get(ENCDEC_ARCH).replace(
        quant="ternary_packed", n_layers=FAMILY_ENCDEC_LAYERS,
        enc_layers=FAMILY_ENCDEC_LAYERS)


def family_launches(cfg, prompt: int) -> int:
    """Kernel 7's launches in one family cell: the prefill step's forward,
    (whisper: the encode and k/v of the cross cache) and prompt +
    FAMILY_STEPS decode steps."""
    steps = prompt + FAMILY_STEPS
    if cfg.family == "encdec":
        fwd = 6 * cfg.enc_layers + 10 * cfg.n_layers     # + xattn k, v
        cross = 6 * cfg.enc_layers + 2 * cfg.n_layers    # encode, k, v
        return fwd + cross + 8 * cfg.n_layers * steps
    per = 3 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every
                                  if cfg.family == "hybrid" else 0)
    return per * (1 + steps)


def family_inputs(torch, cfg, fam: str) -> dict:
    """The cell's seeded prompt (and whisper's frames) on the card."""
    b, p = FAMILY_BATCH[fam], FAMILY_PROMPT[fam]
    rng = np.random.default_rng(SEED + 40)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, p)),
                                     device=DEVICE)}
    if fam == "encdec":
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(SEED + 41)
        out["frames"] = torch.randn((b, cfg.enc_seq, cfg.d_model),
                                    generator=gen, device=DEVICE
                                    ).to(torch.bfloat16)
    return out


def _family_run(torch, TF, DEC, C, SH, ST, cfg, params, inp, mesh=None,
                fed=None) -> dict:
    """One family cell: `build_cell`'s prefill step on the prompt, then
    the prompt teacher-forced and FAMILY_STEPS steps (``fed`` tokens, or
    greedy) through its decode step from zero caches (whisper's cross
    cache from the encoder's output), unmeshed with ``mesh`` None.
    Returns every logits row (gathered), the tokens fed, ms per decode
    step and the caches."""
    from repro_torch.models.config import ShapeSpec

    b, p = inp["tokens"].shape
    if mesh is None:
        def prefill(prm, bt):
            return TF.forward_logits(prm, bt, cfg)

        def step(prm, tok, caches, pos):
            return DEC.decode_step(prm, tok, caches, pos, cfg)
        local, lin, caches = params, inp, DEC.init_caches(
            cfg, b, FAMILY_MAX_LEN, device=DEVICE)

        def cut(t, _spec):
            return t

        def whole(t, _spec):
            return t
        out_spec = tok_spec = pos_spec = None
    else:
        prefill, _, psp = ST.build_cell(cfg, ShapeSpec("p", p, b, "prefill"),
                                        mesh)
        step, _, sp = ST.build_cell(cfg, ShapeSpec(
            "d", FAMILY_MAX_LEN, b, "decode"), mesh)
        pspecs, tok_spec, cache_specs, pos_spec = sp["in"]
        out_spec = sp["out"][0]

        def cut(t, spec):
            return SH.shard_leaf(t, spec, mesh).contiguous()

        def whole(t, spec):
            return SH.gather_leaf(t, spec, mesh)
        local = SH.shard_tree(params, pspecs, mesh)
        lin = {k: cut(v, psp["in"][1][k]) for k, v in inp.items()}
        caches = SH.shard_tree(DEC.init_caches(cfg, b, FAMILY_MAX_LEN,
                                               device=DEVICE),
                               cache_specs, mesh)
    with torch.no_grad():
        rows = [whole(prefill(local, {"tokens": lin["tokens"], **(
            {"frames": lin["frames"]} if "frames" in lin else {})}),
            out_spec)]
        if cfg.family == "encdec":
            with C.use_mesh(mesh):
                enc = TF.encode(local, lin["frames"], cfg)
                for i, lp in enumerate(local["layers"]):
                    k, v = TF._xattn_kv(lp["xattn"], enc, cfg, full_kv=True)
                    caches["cross"]["k"][i] = DEC._seq_slice(k, cfg.enc_seq)
                    caches["cross"]["v"][i] = DEC._seq_slice(v, cfg.enc_seq)
            del enc
        toks, ms = [], []
        for t in range(p + FAMILY_STEPS):
            if t < p:
                tok = inp["tokens"][:, t:t + 1]
            elif fed is not None:
                tok = fed[t - p]
            else:
                tok = rows[-1][:, -1:, :cfg.vocab].argmax(-1)
            if t >= p:
                toks.append(tok)
            pos = torch.full((b,), t, device=DEVICE)
            sync(torch)
            if mesh is not None:
                mesh.barrier()
            t0 = time.perf_counter()
            lg, caches = step(local, cut(tok, tok_spec), caches,
                              cut(pos, pos_spec))
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
            rows.append(whole(lg, out_spec))
    return {"logits": torch.stack(rows), "fed": torch.stack(toks), "ms": ms,
            "caches": caches, "local": local, "lin": lin, "step": step,
            "cut": cut, "tok_spec": tok_spec, "pos_spec": pos_spec}


@contextlib.contextmanager
def row_partials(C, SH, params, spec: str):
    """Inside the block the unmeshed model sums each projection whose
    packed rows ``spec``'s model axis cuts from the ranks' bf16 partial
    products over their K slices, in rank order, as the ranks'
    all-reduce does: the one rounding a model axis adds to a family
    cell (on the CPU the meshed run equals this one bit for bit,
    tests/test_torch_model_mesh.py, whose ranks use this function).
    Each entry of the block walks ``params``' specs anew."""
    from repro_torch.launch import mesh as M

    shape, axes = M.parse(spec)
    mesh = M.StandInMesh(shape, axes)
    tp = mesh.axis_size("model")
    cut = set()

    def walk(t, sp):
        if isinstance(t, dict):
            if "w_packed" in t and sp["w_packed"][0] == "model":
                cut.add(id(t))
            for k, v in t.items():
                walk(v, sp[k])
        elif isinstance(t, list):
            for a, b in zip(t, sp):
                walk(a, b)

    walk(params, SH.param_specs(params, mesh))
    saved = C._linear

    def lin(p, x, quant, psum=None, n_shards=1):
        if id(p) not in cut:
            return saved(p, x, quant, psum, n_shards)
        r = p["w_packed"].shape[0] // tp
        y = None
        for i in range(tp):
            part = saved({"w_packed": p["w_packed"][i * r:(i + 1) * r],
                          "scale": p["scale"]},
                         x[..., 5 * r * i:5 * r * (i + 1)], quant)
            y = part if y is None else y + part
        return y + p["b"] if "b" in p else y

    C._linear = lin
    try:
        yield
    finally:
        C._linear = saved


@contextlib.contextmanager
def xent_inputs():
    """Inside the block every `losses.chunked_xent` call records a copy
    of its hidden rows (the final norm's output) in the yielded list."""
    from repro_torch.models import losses

    seen, saved = [], losses.chunked_xent

    def spy(x, *args, **kw):
        seen.append(x.detach().clone())
        return saved(x, *args, **kw)

    losses.chunked_xent = spy
    try:
        yield seen
    finally:
        losses.chunked_xent = saved


def gpipe_batch(torch, cfg) -> dict:
    rng = np.random.default_rng(SEED + 42)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, (TRAIN_BATCH,
                                                            TRAIN_SEQ)),
                               device=DEVICE) for k in ("tokens", "labels")}


def gpipe_prediction(cfg, spec: str) -> dict:
    """The dry run's exchanges of the pipelined forward on ``spec``: each
    stage walked on ``meta`` tensors on a `StandInMesh` at its
    coordinates (model 0), nothing allocated; per stage the
    collective-permute count and payload bytes, and every record."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import pipeline as PP
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST
    from repro_torch.roofline import hlo

    shape, axes = M.parse(spec)
    aparams = ST.abstract_params(cfg, stacked=True)
    out = {}
    for stage in range(shape[0]):
        mesh = M.StandInMesh(shape, axes, coord={"pod": stage})
        local = SH.shard_tree(aparams, PP.stage_pspecs(aparams, mesh), mesh)
        batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int64,
                                device="meta") for k in ("tokens", "labels")}
        w = hlo.walk(lambda p, b: PP.pipeline_forward_loss(
            p, b, cfg, mesh, n_micro=GPIPE_MICRO), (local, batch), mesh)
        perm = hlo.collective_bytes(w.records)["by_op"]["collective-permute"]
        out[str(stage)] = {"count": perm["count"],
                           "bytes": perm["payload_bytes"],
                           "records": [list(r) for r in w.records],
                           "flops": w.flops,
                           "memory": hlo.memory(w)}
    return out


def gpipe_tp_path(torch, MM, TF, DEC, C, configs, llm, card: str) -> int:
    """GPipe over ``pod`` and the ssm, hybrid and encdec families on a
    model axis (see GPIPE_TP_WORLDS): this process runs the unmeshed
    cells and the dry run's prediction, the ranks the meshed ones.
    Returns the kernel-7 launches summed over every rank's cells."""
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST

    cfg, params = llm["cfg"], llm["params"]
    batch = gpipe_batch(torch, cfg)
    with torch.no_grad(), xent_inputs() as seen:
        flat, _ = TF.forward_loss(params, batch, cfg)
    meta = {"gpipe_loss": float(flat), "digest": _digest(torch, params),
            "families": {}, "prediction": {}}
    for spec in GPIPE_MESHES.values():
        meta["prediction"][spec] = gpipe_prediction(cfg, spec)
    arrays = {k: v.cpu().numpy() for k, v in batch.items()}
    arrays["gpipe_hidden"] = seen[0].float().cpu().numpy()
    del seen
    for fam in ("ssm", "hybrid", "encdec"):
        fcfg = family_cfg(configs, fam)
        fparams = llm_params(torch, TF, fcfg)
        inp = family_inputs(torch, fcfg, fam)
        run = _family_run(torch, TF, DEC, C, SH, ST, fcfg, fparams, inp)
        arrays[f"{fam}/logits"] = run["logits"].float().cpu().numpy()
        arrays[f"{fam}/fed"] = run["fed"].cpu().numpy()
        for spec in {sp for cells in FAMILY_CELLS.values()
                     for f, sp in cells if f == fam and "model:1" not in sp}:
            with row_partials(C, SH, fparams, spec):
                arrays[f"{fam}/{spec}/partials"] = _family_run(
                    torch, TF, DEC, C, SH, ST, fcfg, fparams, inp,
                    fed=run["fed"])["logits"].float().cpu().numpy()
        meta["families"][fam] = {"digest": _digest(torch, fparams),
                                 "ms": float(np.median(run["ms"])),
                                 "params_gb": _param_bytes(fparams) / 1e9}
        del fparams, run
        torch.cuda.empty_cache()
    total = 0
    with tempfile.TemporaryDirectory() as root:
        np.savez(os.path.join(root, "gpipe_tp.npz"), **arrays)
        with open(os.path.join(root, "gpipe_tp.json"), "w") as f:
            json.dump(meta, f)
        for world, backend in GPIPE_TP_WORLDS.items():
            t0 = time.perf_counter()
            ranks = _mesh_world(world, backend, root, "--gpipe-tp-rank")
            wall = time.perf_counter() - t0
            total += _gpipe_tp_report(ranks, world, backend, meta, configs,
                                      card)
            log(f"phase 4: gpipe/tp world {world} on {backend}: "
                f"{len(ranks)} ranks, {wall!r} s wall with their start; "
                f"{card}")
    return total


def _gpipe_tp_report(ranks, world, backend, meta, configs, card) -> int:
    """Check and print one world's results; its kernel-7 launches."""
    launches = 0
    for i, (fam, spec) in enumerate(FAMILY_CELLS[world]):
        got = [r["families"][i] for r in ranks]
        cfg = family_cfg(configs, fam)
        for rank, g in enumerate(got):
            what = f"{fam} on {spec} (rank {rank})"
            if g["launches"] != g["want"]:
                raise RuntimeError(f"{what}: kernel 7 launched "
                                   f"{g['launches']}, want {g['want']}")
            if world == 1 and not g["bitwise"]:
                raise RuntimeError(f"{what}: logits differ from the unmeshed "
                                   "run's")
            lim = FAMILY_MESH_ULPS[f"{fam} {spec}"] if world > 1 else None
            if lim and (g["max_ulps"] > lim[0]
                        or g["partials_prefill_ulps"] > lim[1]
                        or g["partials_decode_ulps"] > lim[2]):
                raise RuntimeError(f"{what}: a logit {g['max_ulps']} ulps "
                                   f"from the unmeshed run's (per row "
                                   f"{g['row_ulps']}), "
                                   f"{g['partials_prefill_ulps']} / "
                                   f"{g['partials_decode_ulps']} (prefill "
                                   f"row / decode rows) from the one with "
                                   f"the row products' partial sums (per "
                                   f"row {g['partials_row_ulps']}); at most "
                                   f"{lim}")
            if sorted(g["vs_plain"]) != sorted(g["slice_shapes"]) or \
                    max(g["vs_plain"].values()) > SSM_MIXER_ULPS:
                raise RuntimeError(f"{what}: kernel 7 against its plain "
                                   f"version {g['vs_plain']}, want rows x "
                                   f"N {g['slice_shapes']} within "
                                   f"{SSM_MIXER_ULPS} ulps")
            launches += g["launches"]
        errs: dict = {}
        for g in got:
            for k, v in g["vs_plain"].items():
                errs[k] = max(errs.get(k, 0.0), v)
        g = got[0]
        log(f"phase 4: {fam} cell {spec} ({cfg.name} ternary_packed, "
            f"{g['depth']}, batch {FAMILY_BATCH[fam]}, "
            f"{FAMILY_PROMPT[fam]}-token prompt + {FAMILY_STEPS} decode "
            f"steps; {backend}): "
            + ("every logit bit-identical to the unmeshed run; "
               if world == 1 else
               f"largest logit difference {max(r['max_ulps'] for r in got)!r}"
               f" bf16 ulps of its row's max |logit| (at most "
               f"{FAMILY_MESH_ULPS[f'{fam} {spec}'][0]}; per row, prefill "
               f"step then each decode step: {g['row_ulps']}); against the "
               f"unmeshed run with the row-cut projections' bf16 partial "
               f"sums (`row_partials`) prefill row "
               f"{max(r['partials_prefill_ulps'] for r in got)!r}, decode "
               f"rows {max(r['partials_decode_ulps'] for r in got)!r} (at "
               f"most {FAMILY_MESH_ULPS[f'{fam} {spec}'][1:]}; per row "
               f"{g['partials_row_ulps']}); ")
            + f"SSM state / caches per rank {g['cache_local']}; out_proj "
            f"packed rows per rank {g['out_proj_rows']}; kernel 7 launched "
            f"{g['launches']} times per rank; decode step ms (slowest "
            f"rank's median) {max(r['ms'] for r in got)!r} (unmeshed "
            f"{meta['families'][fam]['ms']!r}); collective bytes per rank "
            f"per decode step {g['bytes_per_step']}; kernel 7 against its "
            f"plain version per (M, K, N), max |err| in bf16 ulps: "
            f"{ {k: round(v, 3) for k, v in sorted(errs.items())} } "
            f"(tolerance {SSM_MIXER_ULPS}); {world} ranks on one card; "
            f"{card}")
    if world not in GPIPE_MESHES:
        return launches
    spec = GPIPE_MESHES[world]
    got = [r["gpipe"] for r in ranks]
    pred = meta["prediction"][spec]
    for rank, g in enumerate(got):
        what = f"gpipe {spec} (rank {rank})"
        tp = "model" in spec
        if abs(g["loss"] - meta["gpipe_loss"]) > (GPIPE_LOSS_ATOL if tp
                                                  else 0.0) or \
                g["loss"] != got[0]["loss"]:
            raise RuntimeError(f"{what}: loss {g['loss']!r}, unmeshed "
                               f"{meta['gpipe_loss']!r}")
        if g["hidden_ulps"] is not None and (
                g["hidden_ulps"] > GPIPE_HIDDEN_ULPS if tp
                else not g["hidden_equal"]):
            raise RuntimeError(f"{what}: the last stage's final hidden rows "
                               f"{g['hidden_ulps']} ulps from the unmeshed "
                               f"forward's (bit for bit: "
                               f"{g['hidden_equal']})")
        if g["launches"] != g["want"]:
            raise RuntimeError(f"{what}: kernel 7 launched {g['launches']}, "
                               f"want {g['want']}")
        p = pred[str(g["stage"])]
        if g["permutes"] != [p["count"], p["bytes"]] or \
                g["records"] != p["records"]:
            raise RuntimeError(f"{what}: exchanges {g['permutes']} "
                               f"{g['records']}, the dry run predicts "
                               f"{p['count']} {p['bytes']} {p['records']}")
        if max(g["vs_plain"].values()) > SSM_MIXER_ULPS:
            raise RuntimeError(f"{what}: kernel 7 against its plain version "
                               f"{g['vs_plain']}")
        launches += g["launches"]
    errs: dict = {}
    for g in got:
        for k, v in g["vs_plain"].items():
            errs[k] = max(errs.get(k, 0.0), v)
    g = got[0]
    last = next((r for r in got if r["hidden_ulps"] is not None), None)
    if last is None:
        raise RuntimeError(f"gpipe {spec}: no rank saw the final hidden rows")
    log(f"phase 4: gpipe cell {spec} (llama3.2-1B ternary_packed, full "
        f"width and depth, {g['layers']} layers a stage, batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, {GPIPE_MICRO} microbatches; "
        f"{backend}): loss {g['loss']!r}, unmeshed forward_loss "
        f"{meta['gpipe_loss']!r} (|diff| {abs(g['loss'] - meta['gpipe_loss'])!r}"
        f", at most {GPIPE_LOSS_ATOL if 'model' in spec else 0.0}); the "
        f"last stage's final hidden rows "
        + ("bit-identical to the unmeshed forward's"
           if last["hidden_equal"] else
           f"{last['hidden_ulps']!r} bf16 ulps of their row's max |value| "
           f"from the unmeshed forward's (at most {GPIPE_HIDDEN_ULPS})")
        + f"; ms per pipelined forward "
        f"(slowest rank's median) {max(r['ms'] for r in got)!r}; "
        f"collective-permute per rank {g['permutes'][0]} x "
        f"{g['permutes'][1] / max(g['permutes'][0], 1)!r} B = "
        f"{g['permutes'][1]!r} B, the dry run's prediction "
        f"{pred['0']['count']} / {pred['0']['bytes']!r} B (every record "
        f"equal, stage by stage); dry-run memory per rank stage 0 "
        f"{pred['0']['memory']}, last stage "
        f"{pred[str(len(pred) - 1)]['memory']}; kernel 7 launched "
        f"{g['launches']} times per rank; kernel 7 against its plain "
        f"version per (M, K, N), max |err| in bf16 ulps: "
        f"{ {k: round(v, 3) for k, v in sorted(errs.items())} }; {world} "
        f"ranks on one card; {card}")
    return launches


def _packed_rows(local) -> list:
    """(rows, N) of every packed leaf of a local tree, as strings."""
    out: set = set()

    def walk(t):
        if isinstance(t, dict):
            if "w_packed" in t:
                out.add(str(tuple(t["w_packed"].shape)))
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(local)
    return sorted(out)


def _family_rank_cell(torch, MM, TF, DEC, C, M, SH, ST, configs, fam, spec,
                      meta, z, world) -> dict:
    """One rank's family cell on ``spec`` (see FAMILY_CELLS)."""
    cfg = family_cfg(configs, fam)
    params = llm_params(torch, TF, cfg)
    if _digest(torch, params) != meta["families"][fam]["digest"]:
        raise RuntimeError(f"{fam}: the rank drew other weights")
    inp = family_inputs(torch, cfg, fam)
    want = torch.as_tensor(z[f"{fam}/logits"], device=DEVICE)
    fed = torch.as_tensor(z[f"{fam}/fed"], device=DEVICE)
    own = None
    if world == 1:
        own = _family_run(torch, TF, DEC, C, SH, ST, cfg, params, inp,
                          fed=fed)["logits"]
    mesh = M.make_mesh(*M.parse(spec), device=DEVICE)
    reset_launches(MM)
    sent = sum(mesh.sent.values())
    run = _family_run(torch, TF, DEC, C, SH, ST, cfg, params, inp, mesh, fed)
    launches = MM.LAUNCHES["ternary_matmul"]
    steps = FAMILY_PROMPT[fam] + FAMILY_STEPS
    got = run["logits"]
    # kernel 7 against its plain version on the same inputs: one more
    # prefill step's forward and one more decode step
    b = inp["tokens"].shape[0]
    with torch.no_grad(), kernel_vs_plain(torch, MM, C) as vs_plain:
        with C.use_mesh(mesh):
            TF.forward_logits(run["local"], run["lin"], cfg)
        run["step"](run["local"], run["cut"](fed[-1], run["tok_spec"]),
                    run["caches"], run["cut"](torch.full(
                        (b,), steps, device=DEVICE), run["pos_spec"]))
    ulps = (got.float() - want.float()).abs() / _ulp_rows(torch, want)
    part = z.get(f"{fam}/{spec}/partials")
    pulps = (got.float() - torch.as_tensor(part, device=DEVICE)).abs() \
        / _ulp_rows(torch, want) if part is not None else ulps
    lp = run["local"]["layers"][0]
    rows = (lp["mixer"]["out_proj"]["w_packed"].shape[0] if "mixer" in lp
            else lp["attn"]["wo"]["w_packed"].shape[0])
    caches = {f"{k}/{kk}": list(v.shape) for k, d in run["caches"].items()
              for kk, v in d.items()}
    shapes = _packed_rows(run["local"])
    per_rows: dict = {}                  # (packed rows, N) -> worst ulps
    for (_m, k, n), v in vs_plain.items():
        key = str((-(-k // 5), n))
        per_rows[key] = max(per_rows.get(key, 0.0), v)
    return {"launches": launches, "want": family_launches(
                cfg, FAMILY_PROMPT[fam]) if DEVICE == "cuda" else 0,
            "bitwise": own is not None and torch.equal(got, own),
            "max_ulps": float(ulps.max()), "ms": float(np.median(run["ms"])),
            "row_ulps": [round(float(u), 3)
                         for u in ulps.amax(dim=(1, 2, 3))],
            "partials_prefill_ulps": float(pulps[0].max()),
            "partials_decode_ulps": float(pulps[1:].max()),
            "partials_row_ulps": [round(float(u), 3)
                                  for u in pulps.amax(dim=(1, 2, 3))],
            "bytes_per_step": (sum(mesh.sent.values()) - sent) // (steps + 1),
            "depth": (f"{cfg.enc_layers} + {cfg.n_layers} layers"
                      if fam == "encdec" else f"{cfg.n_layers} layers"),
            "cache_local": caches, "out_proj_rows": int(rows),
            "vs_plain": per_rows, "slice_shapes": shapes}


def _gpipe_rank_cell(torch, MM, TF, M, SH, ST, C, cfg, params, z,
                     spec) -> dict:
    """One rank's pipelined forward on ``spec`` (see GPIPE_MESHES)."""
    from repro_torch.launch import pipeline as PP
    from repro_torch.roofline import hlo

    mesh = M.make_mesh(*M.parse(spec), device=DEVICE)
    stacked = TF.stack_layers(params)
    specs = PP.stage_pspecs(ST.abstract_params(cfg, stacked=True), mesh)
    local = SH.shard_tree(stacked, specs, mesh)
    del stacked
    torch.cuda.empty_cache()
    batch = {k: torch.as_tensor(z[k], device=DEVICE)
             for k in ("tokens", "labels")}

    def fwd(p, b):
        return PP.pipeline_forward_loss(p, b, cfg, mesh, n_micro=GPIPE_MICRO)

    ms = []
    with torch.no_grad():
        reset_launches(MM)
        with xent_inputs() as seen:
            w = hlo.walk(fwd, (local, batch), mesh)
        launches = MM.LAUNCHES["ternary_matmul"]
        for _ in range(3):
            sync(torch)
            mesh.barrier()
            t0 = time.perf_counter()
            fwd(local, batch)
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
        with kernel_vs_plain(torch, MM, C) as vs_plain:
            fwd(local, batch)
    perm = hlo.collective_bytes(w.records)["by_op"]["collective-permute"]
    layers = int(local["layers"]["ln1"]["scale"].shape[0])
    # the last stage's final hidden rows against the unmeshed forward's
    hidden_ulps = hidden_equal = None
    if seen:
        want = torch.as_tensor(z["gpipe_hidden"], device=DEVICE)
        got = seen[0].float()
        hidden_equal = bool(torch.equal(got, want))
        hidden_ulps = float(((got - want).abs()
                             / _ulp_rows(torch, want)).max())
    return {"loss": float(w.out[0]), "stage": mesh.coord("pod"),
            "hidden_ulps": hidden_ulps, "hidden_equal": hidden_equal,
            "layers": layers, "ms": float(np.median(ms)),
            "launches": launches,
            "want": 7 * layers * GPIPE_MICRO if DEVICE == "cuda" else 0,
            "permutes": [perm["count"], perm["payload_bytes"]],
            "records": [list(r) for r in w.records],
            "vs_plain": {str(k): v for k, v in vs_plain.items()}}


def gpipe_tp_rank_main(rank: int, world: int, backend: str,
                       root: str) -> int:
    """``--gpipe-tp-rank R WORLD BACKEND DIR``: one rank of the GPipe and
    model-axis family path.  Joins the process group
    (``file://DIR/gpg<WORLD>``), runs its world's family cells and, in
    worlds 2 and 4, the pipelined forward of the main path's llama3.2-1B
    weights (their digest must be the parent's), and writes its results
    to ``DIR/w<WORLD>r<R>.json``; any failed check raises."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.launch import mesh as M
    from repro_torch.launch import shardings as SH
    from repro_torch.launch import steps as ST
    from repro_torch.models import common as C
    from repro_torch.models import decoding as DEC
    from repro_torch.models import transformer as TF

    torch.cuda.set_device(0)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, f'gpg{world}')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        with open(os.path.join(root, "gpipe_tp.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(root, "gpipe_tp.npz")) as z:
            z = {k: z[k] for k in z.files}
        out = {"families": []}
        for fam, spec in FAMILY_CELLS[world]:
            out["families"].append(_family_rank_cell(
                torch, MM, TF, DEC, C, M, SH, ST, configs, fam, spec, meta,
                z, world))
            torch.cuda.empty_cache()
        if world in GPIPE_MESHES:
            cfg = configs.get(LLM_ARCH).replace(quant="ternary_packed",
                                                attn_kv_chunk=16)
            params = llm_params(torch, TF, cfg)
            if _digest(torch, params) != meta["digest"]:
                raise RuntimeError("gpipe: the rank drew other weights")
            out["gpipe"] = _gpipe_rank_cell(torch, MM, TF, M, SH, ST, C, cfg,
                                            params, z, GPIPE_MESHES[world])
        with open(os.path.join(root, f"w{world}r{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _trunk_operands(torch, layers):
    """(w_stack, t_lo, t_hi, flip, const, is_const) of a trunk."""
    import torch.nn.functional as F
    cu = max(layers[0].weights.shape[2], layers[0].weights.shape[3])
    w = torch.stack([F.pad(li.weights, (0, 0, 0, cu - li.weights.shape[2]))
                     for li in layers])
    return (w, *[torch.stack([getattr(li.thresholds, f) for li in layers])
                 for f in ("t_lo", "t_hi", "flip", "const", "is_const")])


def llm_prompts(cfg) -> list:
    """8 prompts of 40 tokens: one shared 32-token prefix + 8 distinct."""
    rng = np.random.default_rng(SEED + 6)
    prefix = rng.integers(0, cfg.vocab, LLM_PREFIX)
    return [np.concatenate([prefix, rng.integers(0, cfg.vocab,
                                                 LLM_PROMPT - LLM_PREFIX)])
            for _ in range(LLM_REQUESTS)]


def llm_params(torch, TF, cfg):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    return TF.init_params(cfg, gen)


def _record_margins(ex) -> dict:
    """Wrap an executor so that it keeps, per request uid, the top-2 logit
    margin of each row it samples a token from (prefill, then each decode
    step)."""
    margins: dict = {}
    admitting: list = []
    prefill, sample = ex.prefill, ex._sample

    def prefill_(uid, tokens):
        admitting.append(uid)
        return prefill(uid, tokens)

    def sample_(lg):
        top = lg[:, :ex.cfg.vocab].float().topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).tolist()
        if admitting:                             # a prefill's first token
            margins.setdefault(admitting.pop(), []).append(gap[0])
        else:                                     # one decode step
            for i, r in enumerate(ex.slots):
                if r is not None:
                    margins[r.uid].append(gap[i])
        return sample(lg)

    ex.prefill, ex._sample = prefill_, sample_
    return margins


def serve(torch, S, params, cfg, prompts, margins=False, digests=False,
          **scfg) -> dict:
    """The requests through CutieEngine + LLMExecutor; returns tokens,
    stats, host-clock seconds and the trace's prefill/decode spans (and,
    with ``margins``, each sampled row's top-2 logit margin per request,
    in request order; with ``digests``, the sha256 of every sampled logits
    tensor, in order)."""
    eng = S.CutieEngine("fcfs")
    ex = S.LLMExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW,
                                                   **scfg))
    gaps = _record_margins(ex) if margins else None
    seen = _logit_digests(ex) if digests else None
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    sync(torch)
    t0 = time.perf_counter()
    out = eng.run()
    sync(torch)
    secs = time.perf_counter() - t0
    spans: dict = {"prefill": [], "decode": []}
    open_: dict = {}
    for ev in eng.trace_export()["traceEvents"]:
        key = (ev["name"], ev.get("tid"))
        if ev["name"] not in spans:
            continue
        if ev["ph"] == "B":
            open_[key] = ev["ts"]
        elif ev["ph"] == "E":
            spans[ev["name"]].append((ev["ts"] - open_.pop(key)) / 1e3)
    return {"tokens": [out[h.uid] for h in hs], "executor": ex,
            "stats": eng.stats(), "seconds": secs, "spans": spans,
            "margins": gaps and [gaps[h.uid] for h in hs], "digests": seen}


def trit_kv_serve(torch, TC, S, codec, params, cfg, prompts, raw,
                  label: str = "llm") -> dict:
    """The same requests with the paged KV rows stored ternarized, 5 trits
    per byte (``kv_codec="trit"``): the codec kernels' KV forms ternarize
    and pack every written row (`ternarize_pack`, kernel 4) and unpack and
    scale every gathered page (`unpack_dequant`, kernel 5), one launch per
    K or V: 2 pack launches per forward, 2 unpack launches per decode step
    and per prefill that gathers a cached prefix.  The codec is exact, so
    the serve with the codec's plain versions on the card must give the
    same tokens, as the reduced-config CPU tests hold the port's trit
    serve against the reference's.  Ternarized KV rows are lossy by
    design, so against ``raw``, a paged serve with the default codec that
    recorded its top-2 logit margins, the agreement is reported, not
    required: per request, the first step that differs and the raw margin
    there."""
    reset_launches(TC)
    trit = serve(torch, S, params, cfg, prompts, kv_codec="trit")
    sync(torch)
    launches = dict(TC.LAUNCHES)
    st = trit["stats"]["paged_state"]["llm"]
    forwards = st["prefills"] + st["decode_steps"]
    if DEVICE == "cuda" and not (
            launches["pack_trits"] == 2 * forwards
            and 2 * st["decode_steps"] <= launches["unpack_trits"]
            <= 2 * forwards and launches["unpack_trits"] % 2 == 0):
        raise RuntimeError(f"{label} trit: codec launches {launches} for "
                           f"{st['prefills']} prefills + "
                           f"{st['decode_steps']} decode steps, want 2 per "
                           "K and V write and gather")

    saved, codec._tc = codec._tc, _PlainCodec(TC)
    try:
        plain = serve(torch, S, params, cfg, prompts, kv_codec="trit")
    finally:
        codec._tc = saved
    if plain["tokens"] != trit["tokens"]:
        raise RuntimeError(f"{label} trit: tokens with the codec kernels "
                           "differ from those with the plain codec")
    first = []
    for t, r, gaps in zip(trit["tokens"], raw["tokens"], raw["margins"]):
        j = next((j for j, (a, b) in enumerate(zip(t, r)) if a != b), None)
        first.append(None if j is None else (j, gaps[j]))
    same = sum(a == b for t, r in zip(trit["tokens"], raw["tokens"])
               for a, b in zip(t, r))
    log(f"phase 4: {label} kv_codec='trit' paged: pack_trits (ternarize_pack) "
        f"launched {launches['pack_trits']} times, unpack_trits "
        f"(unpack_dequant) {launches['unpack_trits']} ({st['prefills']} "
        f"prefills + {st['decode_steps']} decode steps); tokens identical "
        f"with the plain codec on the card; against the raw serve {same} "
        f"of {LLM_REQUESTS * LLM_NEW} tokens equal, first difference per "
        f"request (step, raw top-2 margin there): {first}")
    return {"launches": launches, "first": first, "tokens": trit["tokens"]}


class _PlainCodec:
    """The codec module as `repro_torch.core.codec` reaches it, with every
    kernel wrapper replaced by its plain version."""

    def __init__(self, TC):
        self.TRITS_PER_BYTE = TC.TRITS_PER_BYTE
        self.pack_trits = TC.pack_trits_plain
        self.unpack_trits = TC.unpack_trits_plain
        self.ternarize_pack = TC.ternarize_pack_plain
        self.unpack_dequant = TC.unpack_dequant_plain


class _ChainCodec(_PlainCodec):
    """The codec as the KV store composed it before its KV forms: the
    codec kernels proper inside the eager torch ops around them (ternarize
    rows, then pack; unpack, then trim, f32, scale and bf16)."""

    def __init__(self, torch, TC):
        super().__init__(TC)
        self.pack_trits = TC.pack_trits
        self.unpack_trits = TC.unpack_trits

        def ternarize_pack(x):
            t, scale = TC.ternarize_rows(x)
            return TC.pack_trits(t), scale

        def unpack_dequant(b, scale, n):
            t = TC.unpack_trits(b)[:, :n]
            return (t.float() * scale[:, None]).to(torch.bfloat16)

        self.ternarize_pack = ternarize_pack
        self.unpack_dequant = unpack_dequant


def llm_main_path(torch, MM, TC, S, TF, DEC, C, codec, configs) -> dict:
    """llama3.2-1B, ternary_packed, full width and depth, served through
    CutieEngine + LLMExecutor on the card: tokens, prefix hits and kernel
    7's launch count, then paged against contiguous, then one prefill
    with the plain matmul against the kernel."""
    cfg = configs.get(LLM_ARCH).replace(quant="ternary_packed",
                                        attn_kv_chunk=16)
    params = llm_params(torch, TF, cfg)
    prompts = llm_prompts(cfg)
    sync(torch)
    reset_launches(MM, TC)
    paged = serve(torch, S, params, cfg, prompts)
    sync(torch)
    launches = dict(MM.LAUNCHES)
    st = paged["stats"]["paged_state"]["llm"]
    forwards = st["prefills"] + st["decode_steps"]
    want = 7 * cfg.n_layers * forwards if DEVICE == "cuda" else 0
    lens = [len(t) for t in paged["tokens"]]
    if lens != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"llm: token counts {lens}, want {LLM_NEW} each")
    if not st["prefix_hit_rate"] > 0:
        raise RuntimeError(f"llm: prefix_hit_rate {st['prefix_hit_rate']}")
    if launches["ternary_matmul"] != want or \
            launches["ternary_matmul_dense"] or any(TC.LAUNCHES.values()):
        raise RuntimeError(f"llm: launches {launches} {TC.LAUNCHES}, want "
                           f"ternary_matmul = 7 x {cfg.n_layers} x "
                           f"{forwards} forwards = {want}")
    log(f"phase 4: llm {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, vocab {cfg.vocab}): {LLM_REQUESTS} requests "
        f"x {LLM_PROMPT} tokens -> {LLM_NEW} tokens each; prefix_hit_rate "
        f"{st['prefix_hit_rate']!r}, prefill tokens computed "
        f"{st['prefill_tokens_computed']} of {st['prefill_tokens']}; "
        f"{st['prefills']} prefills + {st['decode_steps']} decode steps; "
        f"ternary_matmul launched {launches['ternary_matmul']} times "
        f"(7 x {cfg.n_layers} x {forwards})")
    contiguous = serve(torch, S, params, cfg, prompts, paged=False)
    if contiguous["tokens"] != paged["tokens"]:
        raise RuntimeError("llm: paged and contiguous tokens differ")
    log("phase 4: llm paged and contiguous serving: tokens identical "
        f"(first request {paged['tokens'][0]})")
    raw = serve(torch, S, params, cfg, prompts, margins=True)
    if raw["tokens"] != paged["tokens"]:
        raise RuntimeError("llm: a second paged serve gave other tokens")
    trit = trit_kv_serve(torch, TC, S, codec, params, cfg, prompts, raw)
    err = plain_prefill_check(torch, MM, DEC, C, params, cfg, prompts[0],
                              "llm")
    return {"cfg": cfg, "params": params, "prompts": prompts,
            "paged": paged, "contiguous": contiguous, "raw": raw,
            "launches": launches["ternary_matmul"], "logit_err": err,
            "trit": trit}


@contextlib.contextmanager
def plain_matmul(MM, C):
    """Inside the block, `linear(quant="ternary_packed")` reaches kernel
    7's plain version instead of the kernel."""
    saved = C._mm
    C._mm = types.SimpleNamespace(ternary_matmul=MM.ternary_matmul_plain)
    try:
        yield
    finally:
        C._mm = saved


def _prefill(torch, DEC, params, cfg, prompt):
    """One cold prefill of ``prompt`` (padded to bucket PREFILL_M): its
    positions' logits over the vocabulary, in float64."""
    toks = torch.as_tensor(np.pad(prompt, (0, PREFILL_M - len(prompt)))
                           [None], device=DEVICE)
    empty = {n: torch.zeros((cfg.n_layers, 1, 0, cfg.n_kv, cfg.d_head),
                            dtype=torch.bfloat16, device=DEVICE)
             for n in ("k", "v")}
    lg, _ = DEC.prefill_with_prefix(params, toks, empty, cfg)
    return lg[0, :len(prompt), :cfg.vocab].double()


def plain_prefill_check(torch, MM, DEC, C, params, cfg, prompt,
                        label: str) -> float:
    """One prefill of ``prompt`` (bucket PREFILL_M) with kernel 7 against
    the same prefill with its plain version on the card: logits within
    LOGIT_TOL.  Returns the max |err|."""
    a = _prefill(torch, DEC, params, cfg, prompt)
    with plain_matmul(MM, C):
        b = _prefill(torch, DEC, params, cfg, prompt)
    sync(torch)
    err = float((a - b).abs().max())
    if not (bool(torch.isfinite(a).all()) and err <= LOGIT_TOL):
        raise RuntimeError(f"{label}: kernel and plain prefill logits differ "
                           f"by {err} (tolerance {LOGIT_TOL})")
    same = float((a.argmax(-1) == b.argmax(-1)).double().mean())
    log(f"phase 4: {label} prefill of {len(prompt)} tokens (bucket "
        f"{PREFILL_M}) with the plain matmul on the card: logits max |err| "
        f"{err!r} (tolerance {LOGIT_TOL}, max |logit| "
        f"{float(b.abs().max())!r}), argmax equal on {same!r} of positions")
    return err


# -- phase 4: the restart path ------------------------------------------------


def _restart_engine(S, params, cfg):
    """The restart path's engine: the LLM main path's executor with the
    paged KV rows stored ternarized (``kv_codec="trit"``)."""
    eng = S.CutieEngine("fcfs")
    ex = S.LLMExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW,
                                                   kv_codec="trit"))
    eng.register("llm", ex)
    return eng, ex


def _logit_digests(ex) -> list:
    """Wrap an executor's sampler: keep the sha256 of the bits of every
    logits tensor it samples a token from, in order."""
    seen, sample = [], ex._sample

    def sample_(lg):
        seen.append(hashlib.sha256(
            lg.detach().float().cpu().numpy().tobytes()).hexdigest())
        return sample(lg)

    ex._sample = sample_
    return seen


def restart_path(torch, TC, S, llm) -> None:
    """The main path's 8 requests on full-width llama3.2-1B with
    ``kv_codec="trit"``, paged: served once uninterrupted, then again for
    ``RESTART_STEPS`` engine steps (some requests decoding, the rest still
    queued for their prefill), snapshotted by `save_serving_state`, and
    restored in a fresh Python process (this script with ``--restore``),
    which rebuilds the engine from the same seeded weights and finishes.
    Every request's tokens, the bits of every logits tensor sampled
    after the snapshot and the executor's stats must equal the
    uninterrupted run's; the restored serve must launch kernels 4, 5
    and 7."""
    cfg, params, prompts = llm["cfg"], llm["params"], llm["prompts"]
    eng, ex = _restart_engine(S, params, cfg)
    want_digests = _logit_digests(ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    out = eng.run()
    want = {h.uid: out[h.uid] for h in hs}
    want_stats = ex.extra_stats()
    eng, ex = _restart_engine(S, params, cfg)
    digests = _logit_digests(ex)
    for pr in prompts:
        eng.submit(pr, model="llm")
    for _ in range(RESTART_STEPS):
        eng.step()
    queued = len(eng.scheduler._queued)
    resident = sum(r is not None for r in ex.slots)
    if not (queued and resident):
        raise RuntimeError(f"restart: {queued} queued and {resident} "
                           "resident requests at the snapshot, want both")
    with tempfile.TemporaryDirectory() as root:
        reset_launches(TC)
        sync(torch)
        t0 = time.perf_counter()
        path = S.save_serving_state(eng, root)
        save_s = time.perf_counter() - t0
        saved = dict(TC.LAUNCHES)
        nbytes = _dir_bytes(path)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--restore", root], capture_output=True,
                           text=True, timeout=900)
        child_s = time.perf_counter() - t0
        if r.returncode:
            raise RuntimeError(f"restart: the restoring process exited "
                               f"{r.returncode}: {r.stderr[-3000:]}")
        with open(os.path.join(root, "restored.json")) as f:
            res = json.load(f)
    got = {int(u): t for u, t in res["tokens"].items()}
    if any(got[u] != want[u] for u in got) or len(got) != queued + resident:
        raise RuntimeError(f"restart: restored tokens {got} differ from the "
                           f"uninterrupted run's {want}")
    if digests + res["digests"] != want_digests:
        raise RuntimeError("restart: logits after the restore differ from "
                           "the uninterrupted run's")
    if res["stats"] != want_stats:
        raise RuntimeError(f"restart: stats {res['stats']} vs the "
                           f"uninterrupted run's {want_stats}")
    served = res["launches_serve"]
    if DEVICE == "cuda" and not all(served[k] for k in (
            "pack_trits", "unpack_trits", "ternary_matmul")):
        raise RuntimeError(f"restart: the restored serve launched {served}")
    log(f"phase 4: restart path: llama3.2-1B kv_codec='trit' paged, "
        f"snapshot after {RESTART_STEPS} engine steps ({resident} requests "
        f"decoding, {queued} queued for prefill): save_serving_state "
        f"{save_s * 1e3!r} ms, {nbytes} bytes on disk, kernel 4/5 launches "
        f"in the save {saved['pack_trits']}/{saved['unpack_trits']} (the "
        f"trit pages are stored as the packed bytes they are)")
    log(f"phase 4: restart path: a fresh process restored it "
        f"(restore_serving_state {res['restore_s'] * 1e3!r} ms, kernel 4/5 "
        f"launches in the restore {res['launches_restore']['pack_trits']}/"
        f"{res['launches_restore']['unpack_trits']}; process wall "
        f"{child_s!r} s with its start and weights) and finished: "
        f"{len(got)} requests' tokens and all {len(want_digests)} sampled "
        f"logits tensors' bits equal to the uninterrupted run's "
        f"({len(digests)} before the snapshot, {len(res['digests'])} after;"
        f" last {want_digests[-1][:16]}), stats equal; the restored serve "
        f"launched {served}")


def restore_main(root: str) -> int:
    """``--restore DIR``: the restart path's second process.  Rebuilds
    the engine from the seeded weights, restores the snapshot under DIR,
    finishes the serve, and writes tokens, logits digests, stats, the
    restore's wall time and the kernel launches to DIR/restored.json."""
    import torch

    from repro_torch import configs
    from repro_torch import serving as S
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.kernels import trit_codec as TC
    from repro_torch.models import transformer as TF

    cfg = configs.get(LLM_ARCH).replace(quant="ternary_packed",
                                        attn_kv_chunk=16)
    params = llm_params(torch, TF, cfg)
    eng, ex = _restart_engine(S, params, cfg)
    digests = _logit_digests(ex)
    reset_launches(MM, TC)
    sync(torch)
    t0 = time.perf_counter()
    handles = S.restore_serving_state(eng, root)
    sync(torch)
    restore_s = time.perf_counter() - t0
    restored = dict(TC.LAUNCHES)
    reset_launches(MM, TC)
    eng.run()
    sync(torch)
    with open(os.path.join(root, "restored.json"), "w") as f:
        json.dump({"tokens": {str(u): h.request.result
                              for u, h in handles.items()},
                   "digests": digests, "stats": ex.extra_stats(),
                   "restore_s": restore_s, "launches_restore": restored,
                   "launches_serve": {**TC.LAUNCHES,
                                      "ternary_matmul":
                                          MM.LAUNCHES["ternary_matmul"]}},
                  f)
    return 0


# -- phase 4: speculative decoding ------------------------------------------


def _record_verifies(ex) -> list:
    """Wrap a spec executor: per verify, (k, the first rejected index or
    None, the verify row's gap between its argmax and the rejected
    proposal, the largest |draft row - verify row| of each proposal
    before the first rejection).  The last entry is a running sha256 of
    every draft and verify row, in order."""
    seen: list = [hashlib.sha256()]
    propose, verify = ex.draft.propose, ex.verifier.verify_kv

    def propose_(slot, uid, tokens, k):
        props, lgs = propose(slot, uid, tokens, k)
        seen.append((props, lgs))
        return props, lgs

    def verify_(*a):
        rows = verify(*a)
        props, lgs = seen.pop()
        seen[0].update(np.ascontiguousarray(lgs).tobytes())
        seen[0].update(np.ascontiguousarray(rows).tobytes())
        greedy = rows.argmax(-1)
        j = next((i for i, d in enumerate(props) if greedy[i] != d), None)
        gap = None if j is None else float(rows[j].max() - rows[j][props[j]])
        n = len(props) if j is None else j
        errs = np.abs(lgs[:n] - rows[:n]).max(-1).tolist()
        seen.append(("done", len(props), j, gap, errs))
        return rows

    ex.draft.propose, ex.verifier.verify_kv = propose_, verify_
    return seen


def spec_serve(torch, MM, TC, S, params, cfg, prompts, dparams, dcfg,
               **scfg) -> dict:
    """The requests through CutieEngine + SpecExecutor (target ``params``,
    draft ``dparams``): tokens, stats, host-clock seconds, the medians of
    the propose and verify spans, each verify's rejection record, and the
    kernel launches of the serve against the formula: kernel 7 launches
    7 x (n_layers x target forwards + draft layers x draft steps)."""
    eng = S.CutieEngine("fcfs")
    ex = S.SpecExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW,
                                                    **scfg), dparams, dcfg)
    seen = _record_verifies(ex)
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    sync(torch)
    reset_launches(MM, TC)
    t0 = time.perf_counter()
    out = eng.run()
    sync(torch)
    secs = time.perf_counter() - t0
    launches = {**MM.LAUNCHES, **TC.LAUNCHES}
    st = ex.extra_stats()
    sp = st["spec"]
    target = st["prefills"] + sp["verify_steps"] + sp["plain_steps"]
    want = 7 * (cfg.n_layers * target + dcfg.n_layers * ex.draft.n_steps) \
        if DEVICE == "cuda" else 0
    if launches["ternary_matmul"] != want or launches["ternary_matmul_dense"]:
        raise RuntimeError(
            f"spec: ternary_matmul launched {launches}, want 7 x "
            f"({cfg.n_layers} x {target} target forwards + {dcfg.n_layers} "
            f"x {ex.draft.n_steps} draft steps) = {want}")
    spans: dict = {"spec_propose": [], "spec_verify": []}
    open_: dict = {}
    for ev in eng.trace_export()["traceEvents"]:
        if ev["name"] not in spans:
            continue
        key = (ev["name"], ev.get("tid"))
        if ev["ph"] == "B":
            open_[key] = ev["ts"]
        elif ev["ph"] == "E":
            spans[ev["name"]].append((ev["ts"] - open_.pop(key)) / 1e3)
    tokens = [out[h.uid] for h in hs]
    if [len(t) for t in tokens] != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"spec: token counts {[len(t) for t in tokens]}")
    return {"tokens": tokens, "stats": st, "seconds": secs,
            "launches": launches, "target_forwards": target,
            "draft_steps": ex.draft.n_steps, "want": want,
            "verifies": [v[1:] for v in seen[1:] if v[0] == "done"],
            "rows_sha256": seen[0].hexdigest(),
            "propose_ms": float(np.median(spans["spec_propose"])),
            "verify_ms": float(np.median(spans["spec_verify"]))}


def _margin_rule(tokens, plain, margins) -> tuple:
    """Spec tokens against the plain serve's: equal up to the first
    difference per request, which must sit at a plain top-2 margin of at
    most 2 x SPEC_LOGIT_TOL.  Returns (tokens compared, differences as
    (request, step, plain margin))."""
    n, diffs = 0, []
    for r, (g, w, gaps) in enumerate(zip(tokens, plain, margins)):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            n += len(w)
            continue
        if gaps[j] > 2 * SPEC_LOGIT_TOL:
            raise RuntimeError(f"spec: request {r} token {j} {g[j]} vs the "
                               f"plain serve's {w[j]} at top-2 margin "
                               f"{gaps[j]} > {2 * SPEC_LOGIT_TOL}")
        n += j
        diffs.append((r, j, gaps[j]))
    return n, diffs


def _decode_vs_forward(torch, S, DEC, params, cfg, prompt) -> list:
    """The reference's rounding gap without spec code: one request through
    the plain paged serve, keeping the row each decode step samples from,
    then one forward over the prompt and the generated tokens
    (`DEC.prefill_with_prefix`, the verify's path).  Returns, per decode
    step, max |decode row - forward row| of the same position."""
    eng = S.CutieEngine("fcfs")
    ex = S.LLMExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW))
    rows, sample = [], ex._sample

    def sample_(lg):
        i = next((i for i, r in enumerate(ex.slots) if r is not None), 0)
        rows.append(lg[i, :cfg.vocab].float().cpu().numpy())
        return sample(lg)

    ex._sample = sample_
    eng.register("llm", ex)
    h = eng.submit(prompt, model="llm")
    out = eng.run()[h.uid]
    toks = np.concatenate([prompt, out[:-1]])
    x = torch.as_tensor(np.pad(toks, (0, PREFILL_M - len(toks)))[None],
                        device=DEVICE)
    empty = {n: torch.zeros((cfg.n_layers, 1, 0, cfg.n_kv, cfg.d_head),
                            dtype=torch.bfloat16, device=DEVICE)
             for n in ("k", "v")}
    lg, _ = DEC.prefill_with_prefix(params, x, empty, cfg)
    fwd = lg[0, len(prompt):len(toks), :cfg.vocab].float().cpu().numpy()
    return np.abs(np.stack(rows[1:]) - fwd).max(-1).tolist()


def spec_path(torch, MM, TC, S, TF, DEC, codec, llm, card: str) -> dict:
    """Speculative decoding on the LLM main path's target (full-width
    llama3.2-1B, every projection ternary_packed, paged, 4 slots) and its
    8 requests, with three drafts as tests/test_spec_decode.py builds
    them: (a) the target's first SPEC_DRAFT_LAYERS layers sharing its
    embedding and head, (b) the target itself, (c) a random
    SPEC_DRAFT_LAYERS-layer llama3.2-1B seeded 1; then (a) with
    ``kv_codec="trit"`` (kernels 4 and 5 on the target's and the draft's
    pages), served again with the codec's plain versions, which must give
    the same tokens and the same draft and verify rows bit for bit, and
    (a) at temperature 0.8.  Greedy tokens are held to the plain serve's
    under the margin rule; a self-draft rejection must sit where the
    verify row holds the proposal within 2 x SPEC_LOGIT_TOL of its argmax,
    and draft and verify rows before a rejection (the same positions and
    tokens, decode step against suffix forward) within SPEC_ROW_TOL, as
    must the plain serve's decode rows against one forward over the same
    tokens; the kernel launches equal the formula in every run."""
    cfg, params, prompts = llm["cfg"], llm["params"], llm["prompts"]
    raw = llm["raw"]
    dcfg = cfg.replace(n_layers=SPEC_DRAFT_LAYERS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    drafts = {
        "truncated": (dict(params,
                           layers=params["layers"][:SPEC_DRAFT_LAYERS]),
                      dcfg),
        "self": (params, cfg),
        "random": (TF.init_params(dcfg, gen), dcfg),
    }
    runs: dict = {}
    for name, (dp, dc) in drafts.items():
        runs[name] = spec_serve(torch, MM, TC, S, params, cfg, prompts, dp,
                                dc)
    runs["truncated trit"] = spec_serve(torch, MM, TC, S, params, cfg,
                                        prompts, *drafts["truncated"],
                                        kv_codec="trit")
    saved, codec._tc = codec._tc, _PlainCodec(TC)
    try:
        plain_trit = spec_serve(torch, MM, TC, S, params, cfg, prompts,
                                *drafts["truncated"], kv_codec="trit")
    finally:
        codec._tc = saved
    kern = runs["truncated trit"]
    if (plain_trit["tokens"] != kern["tokens"]
            or plain_trit["rows_sha256"] != kern["rows_sha256"]
            or plain_trit["verifies"] != kern["verifies"]):
        raise RuntimeError(
            "spec truncated trit: with the plain codec the tokens or the "
            "draft and verify rows differ from those with the codec kernels"
            f" (first difference per request "
            f"{_first_diffs(plain_trit['tokens'], kern['tokens'])}, rows "
            f"{plain_trit['rows_sha256'][:16]} vs {kern['rows_sha256'][:16]})")
    log(f"phase 4: spec truncated trit draft served again with the codec's "
        f"plain versions (pack/unpack_trits launched "
        f"{plain_trit['launches']['pack_trits']}/"
        f"{plain_trit['launches']['unpack_trits']}): tokens identical, "
        f"{len(kern['verifies'])} verifies' draft and verify rows "
        f"bit-identical (sha256 {kern['rows_sha256'][:16]})")
    runs["truncated t=0.8"] = spec_serve(torch, MM, TC, S, params, cfg,
                                         prompts, *drafts["truncated"],
                                         temperature=0.8)
    base = _decode_vs_forward(torch, S, DEC, params, cfg, prompts[0])
    if max(base) > SPEC_ROW_TOL:
        raise RuntimeError(f"llm: decode rows against one forward over the "
                           f"same tokens differ by {max(base)} > "
                           f"{SPEC_ROW_TOL}")
    log(f"phase 4: plain serve, request 0: decode-step rows against one "
        f"prefill_with_prefix forward over the same {LLM_PROMPT + LLM_NEW - 1}"
        f" tokens, max |err| per step {base} (max {max(base)!r}, "
        f"{sum(e > SPEC_LOGIT_TOL for e in base)} of {len(base)} over "
        f"{SPEC_LOGIT_TOL}, tolerance {SPEC_ROW_TOL}); {card}")
    for name, run in runs.items():
        sp = run["stats"]["spec"]
        trit = "trit" in name
        if DEVICE == "cuda" and (
                trit != bool(run["launches"]["pack_trits"]) or
                trit != bool(run["launches"]["unpack_trits"])):
            raise RuntimeError(f"spec {name}: codec launches "
                               f"{run['launches']}")
        if trit and DEVICE == "cuda":
            forwards = run["target_forwards"] + run["draft_steps"]
            if not (run["launches"]["pack_trits"] == 2 * forwards and
                    run["launches"]["unpack_trits"] <= 2 * forwards):
                raise RuntimeError(f"spec {name}: codec launches "
                                   f"{run['launches']} for {forwards} "
                                   "forwards, want 2 writes per forward")
        if "t=" in name or trit:
            note = "tokens not compared" if "t=" in name else (
                "tokens and rows identical with the plain codec; against "
                "the plain trit serve, first difference per request "
                f"{_first_diffs(run['tokens'], llm['trit']['tokens'])}")
        else:
            n, diffs = _margin_rule(run["tokens"], raw["tokens"],
                                    raw["margins"])
            note = (f"{n} of {LLM_REQUESTS * LLM_NEW} tokens equal to the "
                    f"plain serve's, differences (request, step, plain "
                    f"margin) {diffs}")
        rej = [v for v in run["verifies"] if v[1] is not None]
        errs = [e for v in run["verifies"] for e in v[3]]  # a self-draft's
        if name == "self":
            bad = [v for v in rej if v[2] > 2 * SPEC_LOGIT_TOL]
            if bad or sp["tokens_per_verify"] <= 2:
                raise RuntimeError(f"spec self-draft: rejections away from "
                                   f"a near tie {bad}, tokens_per_verify "
                                   f"{sp['tokens_per_verify']}")
            if max(errs) > SPEC_ROW_TOL:
                raise RuntimeError(f"spec self-draft: draft and verify rows "
                                   f"of the same positions differ by "
                                   f"{max(errs)} > {SPEC_ROW_TOL}")
        toks = sum(len(t) for t in run["tokens"])
        log(f"phase 4: spec {name} draft ({run['draft_steps']} draft steps "
            f"of {drafts[name.split()[0]][1].n_layers} layers): "
            f"{toks / run['seconds']!r} tokens/s ({run['seconds']!r} s); "
            f"tokens_per_verify {sp['tokens_per_verify']!r}, acceptance "
            f"{sp['acceptance_rate']!r}, k_current {sp['k_current']}, "
            f"{sp['verify_steps']} verifies + {sp['plain_steps']} plain "
            f"steps; propose ms median {run['propose_ms']!r}, verify ms "
            f"median {run['verify_ms']!r}; ternary_matmul launched "
            f"{run['launches']['ternary_matmul']} = formula {run['want']}, "
            f"pack/unpack_trits {run['launches']['pack_trits']}/"
            f"{run['launches']['unpack_trits']}; {len(rej)} verifies "
            f"rejected (gaps at the rejection "
            f"{[round(v[2], 6) for v in rej][:12]})"
            + (f", draft (decode step) vs verify rows before a rejection: "
               f"{len(errs)} rows, max |err| {max(errs)!r}, median "
               f"{float(np.median(errs))!r}, "
               f"{sum(e > SPEC_LOGIT_TOL for e in errs)} over "
               f"{SPEC_LOGIT_TOL} (tolerance {SPEC_ROW_TOL})"
               if name == "self" else "")
            + f"; {note}; {card}")
    return runs


def _first_diffs(tokens, other) -> list:
    return [next((j for j, (a, b) in enumerate(zip(t, o)) if a != b), None)
            for t, o in zip(tokens, other)]


# -- phase 4: the LLM training path -------------------------------------------


def _train_argv(history: str, *extra) -> list:
    return ["--arch", LLM_ARCH, "--full-config", "--quant", "ternary",
            "--steps", str(TRAIN_STEPS), "--seq", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--log-every", "1", "--history", history,
            *extra]


def _read_history(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def llm_inq_check(torch, TF, loop, inq, cfg) -> str:
    """Full-width QAT with the paper's INQ schedule through `loop.train`
    for TRAIN_INQ_STEPS steps (the schedule's phases compressed into
    them: 70% of every matrix frozen before step 0, the rest before step
    1).  Each freeze quantizes its group to 0 and +-one scale of its own,
    so every matrix ends fully frozen, its effective weights equal to the
    stored q and taking at most as many nonzero magnitudes as there were
    freezes; every loss finite."""
    from repro_torch.data import tokens
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam

    src = tokens.for_arch(cfg, ShapeSpec("cli", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    res = loop.train(
        lambda p, b: TF.forward_loss(TF.unstack_layers(p), b, cfg),
        TF.stack_layers(TF.init_params(cfg, gen)),
        lambda s: {k: torch.as_tensor(v, dtype=torch.int64, device=DEVICE)
                   for k, v in src.batch(s).items()},
        loop.TrainLoopConfig(total_steps=TRAIN_INQ_STEPS, log_every=1,
                             inq=inq.INQConfig()),
        adam.AdamConfig(total_steps=TRAIN_INQ_STEPS, warmup_steps=1))
    hist, st = res["history"], res["inq_state"]
    losses = [r["loss"] for r in hist]
    freezes = len({r["inq_frac"] for r in hist})
    mags = []
    for s_, w in zip(inq._state_leaves(st, keep_none=True),
                     inq._leaves(inq.apply(st, res["params"]))):
        if s_ is None:
            continue
        if not bool((s_["mask"] > 0).all()) or not torch.equal(w, s_["q"]):
            raise RuntimeError("llm INQ: a matrix is not wholly frozen to "
                               "its q values")
        a = w.abs()
        mags.append(int(torch.unique(a[a > 0]).numel()))
    if not all(np.isfinite(losses)) or max(mags) > freezes:
        raise RuntimeError(f"llm INQ: losses {losses}, nonzero magnitudes "
                           f"per matrix {mags} for {freezes} freezes")
    return (f"INQ run through loop.train ({TRAIN_INQ_STEPS} steps, frozen "
            f"fractions {[r['inq_frac'] for r in hist]}, losses {losses}): "
            f"{len(mags)} matrices wholly frozen, nonzero magnitudes per "
            f"matrix {mags} (at most {freezes}, one scale per freeze), "
            f"weight sparsity {inq.weight_sparsity(st, res['params'])!r}")


def llm_train_path(torch, TF, inq, loop, card: str) -> None:
    """Full-width llama3.2-1B QAT (``quant="ternary"``, batch TRAIN_BATCH,
    seq TRAIN_SEQ) through `python -m repro_torch.launch.train`: an
    uninterrupted TRAIN_STEPS-step run in this process, then a run in a
    subprocess checkpointing every TRAIN_CKPT_EVERY steps and preempted at
    TRAIN_FAIL_AT (it must raise PreemptionError), then the same command
    without the preemption, which must resume from the checkpoint and
    give the uninterrupted run's losses within TRAIN_RESUME_ATOL.  Prints
    the step ms, the forward + backward share, launches per step, peak
    memory and the loss history; every loss finite.  Between the two,
    `llm_inq_check`: the frozen weights of an INQ run are trits times
    their freeze's scale."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.launch import train as launch_train

    with tempfile.TemporaryDirectory() as root:
        free = shutil.disk_usage(root).free
        hist = os.path.join(root, "full.jsonl")
        torch.cuda.reset_peak_memory_stats()
        res = launch_train.main(_train_argv(hist))
        sync(torch)
        peak = torch.cuda.max_memory_allocated()
        full = _read_history(hist)
        losses = [r["loss"] for r in full]
        if not all(np.isfinite(losses)) or len(full) != TRAIN_STEPS:
            raise RuntimeError(f"llm train: history {full}")
        cfg = configs.get(LLM_ARCH).replace(quant="ternary")
        step, batch = _train_step_parts(torch, TF, loop, cfg, res)
        del res
        fb, fb_min = _median_ms(torch, batch, reps=3, warm=1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            sync(torch)
            wall = (time.perf_counter() - t0) * 1e3
        ev = prof.key_averages()
        # the kernels' own rows: the CPU ops' rows carry their kernels'
        # device time too, and would count it twice
        dev = [e for e in ev if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
        kernels = sum(e.count for e in dev)
        launch_calls = sum(e.count for e in ev if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        step_ms = [r["dt_s"] * 1e3 for r in full[1:]]
        st = float(np.median(step_ms))
        log(f"phase 4: llm QAT {LLM_ARCH} full width (quant='ternary', "
            f"batch {TRAIN_BATCH}, seq {TRAIN_SEQ}) through launch.train: "
            f"loss history {losses}; step ms median {st!r} over steps "
            f"1-{TRAIN_STEPS - 1} (loop's clock, {step_ms}); peak memory "
            f"{peak / 2**30!r} GiB; {card}")
        log(f"phase 4: llm QAT forward + backward median ms {fb!r} (min "
            f"{fb_min!r}; {fb / st!r} of the step median); one step under "
            f"torch.profiler ({wall!r} ms): {kernels} device kernels, "
            f"{launch_calls} kernel launch calls, device busy {busy!r} ms "
            f"(busy share {busy / wall!r}); {card}")
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"  device {e.self_device_time_total / 1e3!r} ms in "
                f"{e.count} calls: {e.key[:90]}")
        del step, batch
        torch.cuda.empty_cache()
        log(f"phase 4: llm QAT {llm_inq_check(torch, TF, loop, inq, cfg)}; "
            f"{card}")
        torch.cuda.empty_cache()

        ckpt = os.path.join(root, "ckpt")
        env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
        cmd = [sys.executable, "-m", "repro_torch.launch.train"]
        t0 = time.perf_counter()
        cut = subprocess.run(
            cmd + _train_argv(os.path.join(root, "cut.jsonl"), "--ckpt-dir",
                              ckpt, "--ckpt-every", str(TRAIN_CKPT_EVERY),
                              "--fail-at-step", str(TRAIN_FAIL_AT)),
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
        cut_s = time.perf_counter() - t0
        if cut.returncode == 0 or "PreemptionError" not in cut.stderr:
            raise RuntimeError(f"llm train: the preempted run exited "
                               f"{cut.returncode}: {cut.stderr[-3000:]}")
        nbytes = _dir_bytes(os.path.join(ckpt,
                                         f"step_{TRAIN_CKPT_EVERY:09d}"))
        t0 = time.perf_counter()
        again = subprocess.run(
            cmd + _train_argv(os.path.join(root, "resumed.jsonl"),
                              "--ckpt-dir", ckpt, "--ckpt-every",
                              str(TRAIN_CKPT_EVERY)),
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
        again_s = time.perf_counter() - t0
        want = f"(restored from checkpoint step {TRAIN_CKPT_EVERY})"
        if again.returncode or want not in again.stdout:
            raise RuntimeError(f"llm train: the resumed run exited "
                               f"{again.returncode}: {again.stdout[-2000:]}"
                               f" {again.stderr[-3000:]}")
        resumed = _read_history(os.path.join(root, "resumed.jsonl"))
    got = {r["step"]: r["loss"] for r in resumed}
    ref = {r["step"]: r["loss"] for r in full}
    if sorted(got) != list(range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS)) or any(
            abs(got[s] - ref[s]) > TRAIN_RESUME_ATOL for s in got):
        raise RuntimeError(f"llm train: resumed losses {got} against the "
                           f"uninterrupted run's {ref}")
    log(f"phase 4: llm QAT preempted at step {TRAIN_FAIL_AT} "
        f"(PreemptionError, {cut_s!r} s with the step-{TRAIN_CKPT_EVERY} "
        f"checkpoint, {nbytes} bytes; {free / 2**30!r} GiB free before), "
        f"resumed from step {TRAIN_CKPT_EVERY} in a fresh process "
        f"({again_s!r} s): losses {got} against the uninterrupted run's "
        f"{ {s: ref[s] for s in got} } (|diff| max "
        f"{max(abs(got[s] - ref[s]) for s in got)!r}, tolerance "
        f"{TRAIN_RESUME_ATOL}); {card}")


def _train_step_parts(torch, TF, loop, cfg, res) -> tuple:
    """One QAT step (`loop.make_step`) and its forward + backward alone,
    on the trained run's params and Adam state and batch 0."""
    from repro_torch.data import tokens
    from repro_torch.models.config import ShapeSpec
    from repro_torch.optim import adam

    src = tokens.for_arch(cfg, ShapeSpec("cli", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    batch = {k: torch.as_tensor(v, dtype=torch.int64, device=DEVICE)
             for k, v in src.batch(0).items()}
    acfg = adam.AdamConfig(total_steps=TRAIN_STEPS, warmup_steps=1)
    step_fn = loop.make_step(
        lambda p, b: TF.forward_loss(TF.unstack_layers(p), b, cfg), acfg,
        loop.TrainLoopConfig(total_steps=TRAIN_STEPS))
    state = {"p": res["params"], "opt": res["opt_state"]}

    def step():
        state["p"], state["opt"], _ = step_fn(state["p"], state["opt"],
                                              None, batch)

    def fwd_bwd():
        leaves = [t.detach().requires_grad_(True)
                  for t in loop._leaves(state["p"])]
        p = loop._rebuild(state["p"], iter(leaves))
        loss, _ = TF.forward_loss(TF.unstack_layers(p), batch, cfg)
        torch.autograd.grad(loss, leaves)

    return step, fwd_bwd


# -- phase 4: the moe and ssm families ---------------------------------------


def moe_launches_per_forward(cfg) -> int:
    """Kernel 7's launches in one forward of a moe config: 4 attention
    projections per layer, 3 per leading dense layer's FFN and 3 per MoE
    layer's shared-expert SwiGLU (the router and the routed experts are
    plain matmuls)."""
    n_moe = cfg.n_layers - cfg.first_dense
    return (4 * cfg.n_layers + 3 * cfg.first_dense
            + (3 * n_moe if cfg.n_shared_experts else 0))


@contextlib.contextmanager
def routes(torch, moe, forced=None):
    """Wrap `moe.route` inside the block: yields the list of each call's
    (experts (T, k), router probabilities (T, E)); with ``forced``, the
    list of an earlier run, call i routes to forced[i]'s experts (the
    gates renormalized over this run's own probabilities)."""
    seen, route = [], moe.route

    def route_(p, xt, cfg):
        logits, probs, gates, idx = route(p, xt, cfg)
        if forced is not None:
            idx = forced[len(seen)][0]
            top = probs.gather(1, idx)
            gates = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
        seen.append((idx, probs))
        return logits, probs, gates, idx

    moe.route = route_
    try:
        yield seen
    finally:
        moe.route = route


def _route_counts(idx, cfg, cap: int) -> tuple:
    """(assignments per expert, assignments dropped past ``cap``) of one
    route call's experts idx (T, k): dispatch keeps an expert's first
    ``cap`` assignments in token order."""
    per = idx.reshape(-1).bincount(minlength=cfg.n_experts).tolist()
    return per, sum(max(0, c - cap) for c in per)


def _param_bytes(tree) -> int:
    if tree is None:                       # whisper's dec_pos
        return 0
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def moe_path(torch, MM, TC, S, TF, DEC, C, codec, moe, configs, card: str,
             cfg=None) -> dict:
    """deepseek-moe-16b, ternary_packed, at full width and depth with
    seeded weights on the card, serving the LLM path's 8 requests through
    CutieEngine + LLMExecutor: kernel 7 launches `moe_launches_per_forward`
    per forward (196), paged and contiguous give the same tokens, a second
    paged serve the same tokens and logits bits (the combine adds in a
    fixed order), one prefill with the plain matmul agrees with the
    kernel's within LOGIT_TOL, and the serve with ``kv_codec="trit"``
    (kernels 4 and 5) gives the tokens of the same serve with the codec's
    plain versions; the route histogram of one decode step, the dropped
    assignments of one prefill, then the serving times and the device's
    busy share."""
    cfg = cfg or configs.get(MOE_ARCH).replace(quant="ternary_packed",
                                               attn_kv_chunk=16)
    t0 = time.perf_counter()
    params = llm_params(torch, TF, cfg)
    sync(torch)
    init_s = time.perf_counter() - t0
    n_moe = cfg.n_layers - cfg.first_dense
    experts = sum(_param_bytes({k: lp["moe"][k] for k in (
        "gate_proj", "up_proj", "down_proj")}) for lp in params["layers"])
    per_fwd = moe_launches_per_forward(cfg)
    prompts = llm_prompts(cfg)
    log(f"phase 4: moe {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers of which {cfg.first_dense} dense, "
        f"{cfg.n_experts} experts top-{cfg.topk} of width "
        f"{cfg.d_ff_expert}, {cfg.n_shared_experts} shared): parameters "
        f"{_param_bytes(params) / 1e9!r} GB on the card (routed experts "
        f"{experts / 1e9!r} GB bf16), drawn in {init_s!r} s; kernel 7 per "
        f"forward 4 x {cfg.n_layers} + 3 x {cfg.first_dense} + 3 x {n_moe} "
        f"= {per_fwd}")
    reset_launches(MM, TC)
    paged = serve(torch, S, params, cfg, prompts, margins=True, digests=True)
    sync(torch)
    launches = dict(MM.LAUNCHES)
    st = paged["stats"]["paged_state"]["llm"]
    forwards = st["prefills"] + st["decode_steps"]
    want = per_fwd * forwards if DEVICE == "cuda" else 0
    lens = [len(t) for t in paged["tokens"]]
    if lens != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"moe: token counts {lens}, want {LLM_NEW} each")
    if not st["prefix_hit_rate"] > 0:
        raise RuntimeError(f"moe: prefix_hit_rate {st['prefix_hit_rate']}")
    if launches["ternary_matmul"] != want or \
            launches["ternary_matmul_dense"] or any(TC.LAUNCHES.values()):
        raise RuntimeError(f"moe: launches {launches} {TC.LAUNCHES}, want "
                           f"ternary_matmul = {per_fwd} x {forwards} "
                           f"forwards = {want}")
    log(f"phase 4: moe {LLM_REQUESTS} requests x {LLM_PROMPT} tokens -> "
        f"{LLM_NEW} tokens each; prefix_hit_rate {st['prefix_hit_rate']!r}, "
        f"prefill tokens computed {st['prefill_tokens_computed']} of "
        f"{st['prefill_tokens']}; {st['prefills']} prefills + "
        f"{st['decode_steps']} decode steps; ternary_matmul launched "
        f"{launches['ternary_matmul']} times ({per_fwd} x {forwards})")
    contiguous = serve(torch, S, params, cfg, prompts, paged=False)
    if contiguous["tokens"] != paged["tokens"]:
        diff = _first_diffs(contiguous["tokens"], paged["tokens"])
        raise RuntimeError(f"moe: paged and contiguous tokens differ {diff}")
    with routes(torch, moe) as calls:
        again = serve(torch, S, params, cfg, prompts, digests=True)
    if again["tokens"] != paged["tokens"] or \
            again["digests"] != paged["digests"]:
        raise RuntimeError("moe: a second paged serve gave other tokens or "
                           "other logits bits")
    log(f"phase 4: moe paged and contiguous tokens identical; a second "
        f"paged serve identical, tokens and the bits of all "
        f"{len(paged['digests'])} sampled logits tensors")
    slots = S.ServerConfig().n_slots
    first = calls[:n_moe]
    t_pre = first[0][0].shape[0]
    cap = moe._capacity(t_pre, cfg)
    dropped = [_route_counts(idx, cfg, cap)[1] for idx, _ in first]
    i = next(i for i, c in enumerate(calls) if c[0].shape[0] == slots)
    step = [_route_counts(idx, cfg, moe._capacity(slots, cfg))[0]
            for idx, _ in calls[i:i + n_moe]]
    log(f"phase 4: moe routing: first prefill ({t_pre} tokens, the "
        f"bucket-padded prompt, capacity {cap}): dropped assignments per "
        f"MoE layer {dropped} (sum {sum(dropped)}); first decode step "
        f"({slots} tokens, capacity {moe._capacity(slots, cfg)}): layer "
        f"{cfg.first_dense} assignments per expert {step[0]}; experts hit "
        f"per layer {[sum(v > 0 for v in c) for c in step]}, busiest "
        f"expert's assignments per layer {[max(c) for c in step]}")
    moe_plain_prefill_check(torch, MM, DEC, C, moe, params, cfg, prompts[0])
    trit = trit_kv_serve(torch, TC, S, codec, params, cfg, prompts, paged,
                         label="moe")
    _serving_line(f"moe {cfg.name} ternary_packed paged (first run)", paged,
                  card)
    _serving_line(f"moe {cfg.name} ternary_packed contiguous", contiguous,
                  card)
    _serving_line(f"moe {cfg.name} ternary_packed paged (second run)", again,
                  card)
    serving_profile(torch, S, params, cfg, prompts, card,
                    label=f"moe {cfg.name} ternary_packed paged")
    return {"launches": launches["ternary_matmul"],
            "codec": {k: trit["launches"][k] for k in ("pack_trits",
                                                       "unpack_trits")}}


def _ulps(torch, got, want):
    """The largest |got - want| per position (last axis) in bf16 ulps of
    that position's largest |want| (rows (..., D)); a 0-d tensor."""
    w, g = want.float(), got.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().amax(-1).clamp_min(2.0 ** -126))) - 7)
    return ((w - g).abs().amax(-1) / ulp).max()


def moe_plain_prefill_check(torch, MM, DEC, C, moe, params, cfg,
                            prompt) -> None:
    """`plain_prefill_check` for a moe model, in two parts.  Layer by
    layer: a plain-matmul prefill that takes each layer's input and each
    token's experts from the kernel's prefill (teacher forcing) gives
    every layer's increment (output minus input, so the residual stream
    does not dilute it) within MOE_LAYER_ULPS bf16 ulps of the
    increment's largest |value| at each position.  End to end: a plain
    prefill routed as the kernel's gives logits within MOE_LOGIT_TOL of
    the kernel's (the 28 layers of seeded weights carry a residual stream
    of |h| up to about a thousand, and a position's rounding differences
    grow from layer to layer there, as MOE_LOGIT_TOL's note says).
    Routes are held because routing is discontinuous: where a token's
    k-th and (k+1)-th router probabilities nearly tie, a plain prefill
    routed on its own may pick another expert."""
    def prefill(forced=None, inputs=None):
        """(logits, route choices, each layer's (input, output)); with
        ``inputs`` each layer runs on the given input instead of the
        previous layer's output."""
        block, io = DEC._suffix_attn_block, []

        def block_(lp, h, *args):
            if inputs is not None:
                h = inputs[len(io)]
            out = block(lp, h, *args)
            io.append((h, out[0]))
            return out

        DEC._suffix_attn_block = block_
        try:
            with routes(torch, moe, forced) as seen:
                return _prefill(torch, DEC, params, cfg, prompt), seen, io
        finally:
            DEC._suffix_attn_block = block

    n = len(prompt)
    a, kernel_routes, io = prefill()
    with plain_matmul(MM, C):
        _, _, io_plain = prefill(kernel_routes, [h for h, _ in io])
        b, _, _ = prefill(kernel_routes)
    layers = [float(_ulps(torch, (got.float() - h.float())[0, :n],
                          (want.float() - h.float())[0, :n]))
              for (h, want), (_, got) in zip(io, io_plain)]
    err = float((a - b).abs().max())
    log(f"phase 4: moe prefill of {n} tokens (bucket {PREFILL_M}) with the "
        f"plain matmul on the card: layer by layer (each layer on the "
        f"kernel run's input and routes) max |err| of the layer's "
        f"increment in bf16 ulps of the position's largest |increment| "
        f"{[round(e, 3) for e in layers]} (tolerance {MOE_LAYER_ULPS}); end "
        f"to end routed as the kernel's, logits max |err| {err!r} "
        f"(tolerance {MOE_LOGIT_TOL}, max |logit| {float(a.abs().max())!r})")
    if not (bool(torch.isfinite(a).all()) and max(layers) <= MOE_LAYER_ULPS
            and err <= MOE_LOGIT_TOL):
        raise RuntimeError(f"moe: kernel and plain prefill differ: layers "
                           f"{max(layers)} ulps (tolerance {MOE_LAYER_ULPS})"
                           f", logits {err} (tolerance {MOE_LOGIT_TOL})")


def _clone_tree(torch, tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(torch, v) for v in tree]
    if torch.is_tensor(tree):
        return tree.clone()
    return np.array(tree, copy=True)


class _Req:
    def __init__(self, uid, value):
        self.uid, self.value = uid, value


def _drain(ex, done: dict) -> None:
    while ex.has_resident():
        done.update(ex.execute([]).completions)


def ssm_restore(torch, S, params, cfg, prompts) -> str:
    """`LLMExecutor.snapshot` mid-decode (RESTART_STEPS steps into the
    first n_slots requests) and `restore` into a fresh executor in this
    process: the restored serve must emit the same tokens and the same
    bits of every sampled logits tensor as the uninterrupted one."""
    import gc

    def make():
        ex = S.LLMExecutor(params, cfg, S.ServerConfig(
            max_new_tokens=LLM_NEW))
        return ex, _logit_digests(ex)

    ex, seen = make()
    reqs = [_Req(i + 1, p) for i, p in enumerate(prompts[:ex.scfg.n_slots])]
    done = dict(ex.execute(reqs).completions)
    for _ in range(RESTART_STEPS - 1):
        done.update(ex.execute([]).completions)
    tree, meta = ex.snapshot()
    tree = _clone_tree(torch, tree)
    n0 = len(seen)
    _drain(ex, done)
    tail = seen[n0:]
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    ex2, seen2 = make()
    t0 = time.perf_counter()
    ex2.restore(tree, meta)
    sync(torch)
    restore_s = time.perf_counter() - t0
    done2: dict = {}
    _drain(ex2, done2)
    if done2 != {u: done[u] for u in done2} or seen2 != tail \
            or len(done2) != len(reqs):
        raise RuntimeError("ssm: the restored executor's tokens or logits "
                           "differ from the uninterrupted serve's")
    pages = sum(p.numel() * p.element_size() for p in tree["pages"])
    del ex2, tree
    gc.collect()
    torch.cuda.empty_cache()
    return (f"snapshot after {RESTART_STEPS} steps ({pages / 1e9!r} GB of "
            f"state pages) restored in {restore_s!r} s: {len(done2)} "
            f"requests finished with the same tokens and the bits of "
            f"{len(tail)} sampled logits tensors")


def ssm_spec(torch, MM, TC, S, params, cfg, prompts, plain) -> str:
    """The LLM path's requests through SpecExecutor with the target's
    first SSM_DRAFT_LAYERS layers as the draft (sharing its embedding and
    head), two waves of n_slots, so that slots are freed and admitted
    again: greedy tokens under the margin rule against the plain serve's;
    kernel 7 launches 3 x (layers x target token steps + draft layers x draft
    steps), a target token step being a prefill token, a verified token
    (k + 1 per verify) or a plain decode step."""
    dcfg = cfg.replace(n_layers=SSM_DRAFT_LAYERS)
    dparams = dict(params, layers=params["layers"][:SSM_DRAFT_LAYERS])
    eng = S.CutieEngine("fcfs")
    ex = S.SpecExecutor(params, cfg, S.ServerConfig(max_new_tokens=LLM_NEW),
                        dparams, dcfg)
    eng.register("llm", ex)
    hs = [eng.submit(pr, model="llm") for pr in prompts]
    sync(torch)
    reset_launches(MM, TC)
    t0 = time.perf_counter()
    out = eng.run()
    sync(torch)
    secs = time.perf_counter() - t0
    tokens = [out[h.uid] for h in hs]
    st = ex.extra_stats()
    sp = st["spec"]
    steps = (st["prefill_tokens_computed"] + sp["proposed_tokens"]
             + sp["verify_steps"] + sp["plain_steps"])
    want = 3 * (cfg.n_layers * steps + dcfg.n_layers * ex.draft.n_steps) \
        if DEVICE == "cuda" else 0
    if MM.LAUNCHES["ternary_matmul"] != want:
        raise RuntimeError(f"ssm spec: ternary_matmul launched "
                           f"{MM.LAUNCHES['ternary_matmul']}, want 3 x "
                           f"({cfg.n_layers} x {steps} + {dcfg.n_layers} x "
                           f"{ex.draft.n_steps}) = {want}")
    if [len(t) for t in tokens] != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"ssm spec: token counts "
                           f"{[len(t) for t in tokens]}")
    n, diffs = _margin_rule(tokens, plain["tokens"], plain["margins"])
    return (f"spec with a {SSM_DRAFT_LAYERS}-layer truncated draft, "
            f"{LLM_REQUESTS} requests in two waves: "
            f"{sum(len(t) for t in tokens) / secs!r} tokens/s ({secs!r} s), "
            f"tokens_per_verify {sp['tokens_per_verify']!r}, acceptance "
            f"{sp['acceptance_rate']!r}, {sp['verify_steps']} verifies + "
            f"{sp['plain_steps']} plain steps; ternary_matmul launched "
            f"{MM.LAUNCHES['ternary_matmul']} = formula {want}; {n} of "
            f"{LLM_REQUESTS * LLM_NEW} tokens equal to the plain serve's, "
            f"differences (request, step, plain margin) {diffs}")


def ssm_trit_store(torch, TC, codec, cfg) -> dict:
    """`StatePagedStore(codec_name="trit")` on a trit-valued state of the
    serve's shapes on the card: the round trip is exact, kernels 4 and 5
    launch once per leaf written and read, and the pages equal those the
    codec's plain versions write."""
    from repro_torch.models import decoding as DEC
    from repro_torch.serving.blocks import StatePagedStore

    one = DEC.init_caches(cfg, 1, 16, device=DEVICE)["ssm"]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 9)
    state = {k: torch.randint(-1, 2, v[:, 0].shape, generator=gen,
                              device=DEVICE).to(v.dtype)
             for k, v in one.items()}
    reset_launches(TC)
    store = StatePagedStore(3, state, codec_name="trit")
    store.write_(1, state)
    back = store.read_([1])
    sync(torch)
    launches = {k: TC.LAUNCHES[k] for k in ("pack_trits", "unpack_trits")}
    if any(not torch.equal(back[k][0], v) for k, v in state.items()):
        raise RuntimeError("ssm: the trit state store's round trip differs")
    if DEVICE == "cuda" and launches != {"pack_trits": len(state),
                                         "unpack_trits": len(state)}:
        raise RuntimeError(f"ssm: trit state store launches {launches}, "
                           f"want one pack and one unpack per leaf")
    saved, codec._tc = codec._tc, _PlainCodec(TC)
    try:
        plain = StatePagedStore(3, state, codec_name="trit")
        plain.write_(1, state)
    finally:
        codec._tc = saved
    if any(not torch.equal(a, b) for a, b in zip(store.pages, plain.pages)):
        raise RuntimeError("ssm: trit state pages differ from the plain "
                           "codec's")
    log(f"phase 4: ssm StatePagedStore(codec_name='trit') on the card: a "
        f"trit-valued state of the serve's shapes "
        f"{ {k: tuple(v.shape) for k, v in state.items()} } round-trips "
        f"exactly, {store.bytes_per_block()} B per block packed (raw "
        f"{sum(v.numel() * v.element_size() for v in state.values())} B); "
        f"pack/unpack_trits launched {launches['pack_trits']}/"
        f"{launches['unpack_trits']}; pages equal the plain codec's")
    return launches


def ssm_plain_check(torch, MM, DEC, C, params, cfg, prompts,
                    card: str, label: str = "ssm", max_len: int = 16
                    ) -> None:
    """Kernel 7 against its plain version inside mamba2's mixers, at the
    full-width shapes the serve gives it: `DEC.ssm_prefill` over the
    first prompt (M = 1, as the serve's prefill steps) and over the first
    SSM_CHECK_STEPS tokens of n_slots prompts at once (M = n_slots, a
    decode step's batch); every mixer call runs again with the plain
    matmul on the kernel run's input and state, and its output must lie
    within SSM_MIXER_ULPS bf16 ulps of the position's largest |output|.
    A hybrid model's KV caches hold ``max_len`` rows."""
    from repro_torch.models import mamba2

    slots = DECODE_M
    step, errs = mamba2.decode_step, []

    def step_(lp, u, lcfg, state):
        y, new = step(lp, u, lcfg, state)
        with plain_matmul(MM, C):
            want, _ = step(lp, u, lcfg, state)
        errs.append(_ulps(torch, y, want))
        return y, new

    batches = (prompts[0][None],
               np.stack([p[:SSM_CHECK_STEPS] for p in prompts[:slots]]))
    mamba2.decode_step = step_
    try:
        for toks in batches:
            t = torch.as_tensor(toks, device=DEVICE)
            DEC.ssm_prefill(params, t, DEC.init_caches(
                cfg, t.shape[0], max_len, device=DEVICE), cfg)
    finally:
        mamba2.decode_step = step
    per = torch.stack(errs).reshape(-1, cfg.n_layers).amax(0).tolist()
    log(f"phase 4: {label} kernel 7 against its plain version in every mixer "
        f"call of a token-by-token prefill (M = 1, {len(prompts[0])} steps) "
        f"and of {SSM_CHECK_STEPS} steps at M = {slots}: wz, wx "
        f"({cfg.d_model} -> {cfg.d_inner}) and out_proj ({cfg.d_inner} -> "
        f"{cfg.d_model}), each mixer on the kernel run's input and state; "
        f"max |err| of its output per layer in bf16 ulps of the position's "
        f"largest |output| {[round(e, 3) for e in per]} (tolerance "
        f"{SSM_MIXER_ULPS}); {card}")
    if not max(per) <= SSM_MIXER_ULPS:
        raise RuntimeError(f"{label}: kernel 7 and its plain version differ by "
                           f"{max(per)} ulps in a mixer (tolerance "
                           f"{SSM_MIXER_ULPS})")


def ssm_chunked_check(torch, TF, DEC, params, cfg, prompt,
                      label: str = "ssm") -> None:
    """The chunked SSD forward, at chunk SSM_CHECK_CHUNK so that the
    prompt spans several chunks, against the token-by-token recurrence.
    Layer by layer, on the same input (the chunked forward's hidden
    state): each mixer's `apply` against its `decode_step` loop, and for
    the hybrid family each application of the shared block (flash
    attention over the prompt) against its decode steps over a KV cache,
    each within SSM_LAYER_RTOL of the layer's largest |increment| (the two
    round their convolutions, sums and attention differently in bf16).
    End to end (a prompt's last-position logits from `forward_logits`
    against `ssm_prefill`'s): the layers of seeded weights compound those
    differences, so the reference's reduced-size rule
    (test_decode_matches_prefill: correlation above 0.99, |err| within 0.3
    + 0.3 |logit|) is reported; held for the ssm family are a correlation
    above SSM_CORR and the step's argmax among the forward's top 5, and
    reported only for the hybrid family, whose check is the per-layer
    one."""
    from repro_torch.models import attention as ATT
    from repro_torch.models import mamba2

    ccfg = cfg.replace(chunk=SSM_CHECK_CHUNK)
    n = len(prompt)
    toks = torch.as_tensor(prompt[None], device=DEVICE)
    positions = torch.arange(n, device=DEVICE)[None]
    x = TF._embed(params, toks, cfg)
    layers, shared = [], []
    for i, lp in enumerate(params["layers"]):
        xn = TF._norm(cfg, lp["ln"], x)
        full = mamba2.apply(lp["mixer"], xn, ccfg)
        st, steps = mamba2.init_state(cfg, 1, device=DEVICE), []
        for t in range(n):
            y, st = mamba2.decode_step(lp["mixer"], xn[:, t:t + 1], cfg, st)
            steps.append(y)
        d = (torch.cat(steps, 1).float() - full.float()).abs().max()
        layers.append(float(d / full.float().abs().max()))
        x = x + full
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            sp = params["shared_attn"]
            out = TF.dense_block(sp, x, cfg, positions)
            kv = ATT.init_cache(cfg, 1, n, device=DEVICE)
            steps = [DEC._decode_body(x[:, t:t + 1], sp, kv["k"], kv["v"],
                                      cfg=cfg, pos=t) for t in range(n)]
            inc = out.float() - x.float()
            d = (torch.cat(steps, 1).float() - x.float() - inc).abs().max()
            shared.append(float(d / inc.abs().max()))
            x = out
    full = TF.forward_logits(params, {"tokens": toks}, ccfg)[0, -1,
                                                             :cfg.vocab]
    step, _ = DEC.ssm_prefill(params, toks,
                              DEC.init_caches(cfg, 1, n, device=DEVICE), cfg)
    a, f = step[0, -1, :cfg.vocab].double(), full.double()
    corr = float(torch.corrcoef(torch.stack([a, f]))[0, 1])
    err = float((a - f).abs().max())
    ref_rule = corr > 0.99 and bool(((a - f).abs()
                                     <= 0.3 + 0.3 * f.abs()).all())
    top5 = int(a.argmax()) in f.topk(5).indices.tolist()
    worst = max(layers + shared)
    log(f"phase 4: {label} chunked forward (SSD, chunk {SSM_CHECK_CHUNK}: "
        f"{n // SSM_CHECK_CHUNK} chunks, the inter-chunk recurrence "
        f"included) against the token-by-token recurrence: layer by layer "
        f"on the same input, max |err| / max |increment| per mixer "
        f"{[round(e, 4) for e in layers]}"
        + (f", per application of the shared block (flash attention "
           f"against decode steps) {[round(e, 4) for e in shared]}"
           if shared else "")
        + f" (tolerance {SSM_LAYER_RTOL}); end to end, last of {n} "
        f"positions: correlation {corr!r}, max |err| {err!r} (max |logit| "
        f"{float(f.abs().max())!r}), argmax {int(a.argmax())} vs "
        f"{int(f.argmax())} (among the forward's top 5: {top5}; held for "
        f"the ssm family with correlation above {SSM_CORR}: "
        f"{cfg.family == 'ssm'}); the reference's reduced-size rule holds: "
        f"{ref_rule}")
    if worst > SSM_LAYER_RTOL or (cfg.family == "ssm"
                                  and not (corr > SSM_CORR and top5)):
        raise RuntimeError(f"{label}: the chunked forward and the "
                           "token-by-token prefill disagree")


def ssm_path(torch, MM, TC, S, TF, DEC, C, codec, configs, card: str,
             cfg=None) -> dict:
    """mamba2-780m, ternary_packed, at full width and SSM_PATH_LAYERS of
    its 48 layers with seeded
    weights on the card, serving the LLM path's 8 requests paged with
    prefix caching (block-boundary state snapshots): kernel 7 launches
    3 x layers per token through the model (prompt tokens one by one), paged
    and contiguous give the same tokens, kernel 7 agrees with its plain
    version in every mixer call of a prefill, the chunked forward's last logits
    agree with the token-by-token prefill under the reference's
    test_decode_matches_prefill rule, a mid-decode snapshot restores
    bit-identically, a speculative serve with a 2-layer truncated draft
    follows the plain tokens under the margin rule, and the trit state
    store round-trips on the card; then the serving times and the
    device's busy share."""
    cfg = cfg or configs.get(SSM_ARCH).replace(quant="ternary_packed",
                                               n_layers=SSM_PATH_LAYERS)
    params = llm_params(torch, TF, cfg)
    prompts = llm_prompts(cfg)
    per_tok = 3 * cfg.n_layers
    sync(torch)
    reset_launches(MM, TC)
    paged = serve(torch, S, params, cfg, prompts, margins=True)
    sync(torch)
    launches = dict(MM.LAUNCHES)
    st = paged["stats"]["paged_state"]["llm"]
    steps = st["prefill_tokens_computed"] + st["decode_steps"]
    want = per_tok * steps if DEVICE == "cuda" else 0
    store = paged.pop("executor").state_store
    lens = [len(t) for t in paged["tokens"]]
    if lens != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"ssm: token counts {lens}, want {LLM_NEW} each")
    if not st["prefix_hit_rate"] > 0:
        raise RuntimeError(f"ssm: prefix_hit_rate {st['prefix_hit_rate']}")
    if launches["ternary_matmul"] != want or \
            launches["ternary_matmul_dense"] or any(TC.LAUNCHES.values()):
        raise RuntimeError(f"ssm: launches {launches} {TC.LAUNCHES}, want "
                           f"ternary_matmul = {per_tok} x {steps} token "
                           f"steps = {want}")
    log(f"phase 4: ssm {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.ssm_heads} heads x {cfg.ssm_headdim}, "
        f"state {cfg.d_state}, vocab {cfg.vocab}): parameters "
        f"{_param_bytes(params) / 1e9!r} GB; {LLM_REQUESTS} requests x "
        f"{LLM_PROMPT} tokens -> {LLM_NEW} each; prefix_hit_rate "
        f"{st['prefix_hit_rate']!r} ({st['prefix_entries']} snapshots "
        f"cached), prefill tokens computed {st['prefill_tokens_computed']} "
        f"of {st['prefill_tokens']}; {st['decode_steps']} decode steps; "
        f"ternary_matmul launched {launches['ternary_matmul']} times "
        f"(3 x {cfg.n_layers} x {steps} token steps); state snapshot "
        f"{store.bytes_per_block() / 1e6!r} MB per block, pool of "
        f"{store.num_blocks} blocks "
        f"{store.bytes_per_block() * store.num_blocks / 1e9!r} GB")
    del store
    contiguous = serve(torch, S, params, cfg, prompts, paged=False)
    contiguous.pop("executor")
    if contiguous["tokens"] != paged["tokens"]:
        diff = _first_diffs(contiguous["tokens"], paged["tokens"])
        raise RuntimeError(f"ssm: paged and contiguous tokens differ {diff}")
    log("phase 4: ssm paged and contiguous serving: tokens identical "
        f"(first request {paged['tokens'][0]})")
    ssm_plain_check(torch, MM, DEC, C, params, cfg, prompts, card)
    ssm_chunked_check(torch, TF, DEC, params, cfg, prompts[0])
    log("phase 4: ssm " + ssm_restore(torch, S, params, cfg, prompts))
    log("phase 4: ssm " + ssm_spec(torch, MM, TC, S, params, cfg, prompts,
                                   paged) + f"; {card}")
    codec_launches = ssm_trit_store(torch, TC, codec, cfg)
    _serving_line(f"ssm {cfg.name} ternary_packed paged (first run)", paged,
                  card)
    _serving_line(f"ssm {cfg.name} ternary_packed contiguous", contiguous,
                  card)
    serving_profile(torch, S, params, cfg, prompts, card,
                    label=f"ssm {cfg.name} ternary_packed paged")
    return {"launches": launches["ternary_matmul"], "codec": codec_launches}


# -- phase 4: the hybrid, encdec and vlm families ------------------------------


def hybrid_launches_per_step(cfg) -> int:
    """Kernel 7's launches in one token step of a hybrid config: 3 per
    mamba2 mixer (wz, wx, out_proj) and 7 per application of the shared
    block (wq, wk, wv, wo, gate, up, down)."""
    return 3 * cfg.n_layers + 7 * (cfg.n_layers // cfg.attn_every)


def projection_shapes(cfg) -> set:
    """The (K, N) of a hybrid or vlm config's packed projections: the
    attention's and the SwiGLU MLP's, and a hybrid's mixer wz, wx (d_model
    -> d_inner) and out_proj."""
    d, q, kv, f = (cfg.d_model, cfg.n_heads * cfg.d_head,
                   cfg.n_kv * cfg.d_head, cfg.d_ff)
    out = {(d, q), (d, kv), (q, d), (d, f), (f, d)}
    if cfg.family == "hybrid":
        out |= {(d, cfg.d_inner), (cfg.d_inner, d)}
    return out


@contextlib.contextmanager
def kernel_vs_plain(torch, MM, C):
    """Inside the block every packed projection launches kernel 7 and then
    runs its plain version on the same input; yields a dict (M, K, N) ->
    the largest |err| seen, in bf16 ulps of the row's largest |plain
    output| (`_ulps`)."""
    seen: dict = {}

    def mm(x, w, **kw):
        y = MM.ternary_matmul(x, w, **kw)
        err = float(_ulps(torch, y, MM.ternary_matmul_plain(x, w, **kw)))
        key = (x.shape[0], x.shape[1], w.shape[1])
        seen[key] = max(seen.get(key, 0.0), err)
        return y

    saved = C._mm
    C._mm = types.SimpleNamespace(ternary_matmul=mm)
    try:
        yield seen
    finally:
        C._mm = saved


def _fresh_peak(torch) -> None:
    """Free what earlier paths left in reference cycles (executors whose
    methods are wrapped by closures), then restart the peak-memory count,
    so a path's peak is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _busy_share(torch, fn) -> tuple:
    """(host-clock s, device busy s) of one ``fn()`` under torch.profiler
    (CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(torch)
        t0 = time.perf_counter()
        fn()
        sync(torch)
        secs = time.perf_counter() - t0
    return secs, sum(e.self_device_time_total
                     for e in prof.key_averages()) / 1e6


def _greedy(torch, DEC, params, cfg, caches, logits, start, steps) -> tuple:
    """``steps`` greedy decode steps from ``logits`` (B, 1, V) at
    position ``start``: (tokens (B, steps + 1), caches, host ms per
    step)."""
    tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
    out, ms = [tok], []
    b = tok.shape[0]
    for i in range(steps):
        sync(torch)
        t0 = time.perf_counter()
        logits, caches = DEC.decode_step(
            params, tok, caches,
            torch.full((b,), start + i, dtype=torch.int64, device=DEVICE),
            cfg)
        tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append(tok)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"{cfg.name}: non-finite decode logits")
    return torch.cat(out, 1).tolist(), caches, ms


def hybrid_decode(torch, MM, DEC, params, cfg, prompts) -> dict:
    """The prompts through `DEC.ssm_prefill` (token by token) into fresh
    caches of HYBRID_MAX_LEN rows, then LLM_NEW greedy decode steps;
    kernel 7's launches of each part."""
    toks = torch.as_tensor(prompts, device=DEVICE)
    b, s = toks.shape
    caches = DEC.init_caches(cfg, b, HYBRID_MAX_LEN, device=DEVICE)
    sync(torch)
    reset_launches(MM)
    t0 = time.perf_counter()
    logits, caches = DEC.ssm_prefill(params, toks, caches, cfg)
    sync(torch)
    prefill_s = time.perf_counter() - t0
    n_prefill = MM.LAUNCHES["ternary_matmul"]
    reset_launches(MM)
    tokens, caches, ms = _greedy(torch, DEC, params, cfg, caches,
                                 logits[:, -1:], s, LLM_NEW)
    return {"tokens": tokens, "caches": caches, "prefill_s": prefill_s,
            "step_ms": ms, "n_prefill": n_prefill,
            "n_decode": MM.LAUNCHES["ternary_matmul"]}


def hybrid_path(torch, MM, TF, DEC, C, configs, card: str) -> dict:
    """zamba2-2.7b, ternary_packed, at full width and HYBRID_PATH_LAYERS
    of its 54 layers with seeded weights on the card: the first
    HYBRID_BATCH prompts of the LLM path through `ssm_prefill` and
    LLM_NEW greedy decode steps (the reference's serving functions for
    the family; it has no hybrid executor): kernel 7 launches
    `hybrid_launches_per_step` (75 at 18 layers) per token step; in one
    decode step each application of the shared block runs the one ``shared_attn`` dict on its own KV cache,
    and every kernel-7 call (M = HYBRID_BATCH) agrees with its plain
    version within SSM_MIXER_ULPS; every mixer call of a prefill
    (`ssm_plain_check`); the chunked forward against the recurrence layer
    by layer (`ssm_chunked_check`); then the parameter bytes, the host
    medians, the device's busy share of a profiled run and the peak
    memory."""
    cfg = configs.get(HYBRID_ARCH).replace(quant="ternary_packed",
                                           n_layers=HYBRID_PATH_LAYERS)
    _fresh_peak(torch)
    t0 = time.perf_counter()
    params = llm_params(torch, TF, cfg)
    sync(torch)
    init_s = time.perf_counter() - t0
    per_step = hybrid_launches_per_step(cfg)
    n_apps = cfg.n_layers // cfg.attn_every
    all_prompts = llm_prompts(cfg)
    prompts = np.stack(all_prompts[:HYBRID_BATCH])
    log(f"phase 4: hybrid {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} mamba2 layers, {cfg.ssm_heads} heads x "
        f"{cfg.ssm_headdim}, state {cfg.d_state}; one shared block of "
        f"{cfg.n_heads} heads x {cfg.d_head} and MLP {cfg.d_ff} after every "
        f"{cfg.attn_every} layers, {n_apps} applications): parameters "
        f"{_param_bytes(params) / 1e9!r} GB on the card, drawn in "
        f"{init_s!r} s; kernel 7 per token step 3 x {cfg.n_layers} + 7 x "
        f"{n_apps} = {per_step}; {card}")
    run = hybrid_decode(torch, MM, DEC, params, cfg, prompts)
    b, s = prompts.shape
    want = (per_step * s, per_step * LLM_NEW) if DEVICE == "cuda" else (0, 0)
    if (run["n_prefill"], run["n_decode"]) != want:
        raise RuntimeError(f"hybrid: kernel 7 launched {run['n_prefill']} + "
                           f"{run['n_decode']}, want {per_step} x {s} + "
                           f"{per_step} x {LLM_NEW} = {want}")
    caches, end = run["caches"], s + LLM_NEW
    rows = caches["kv"]["k"][:, :, :end].float()
    if not (bool(rows.abs().amax((1, 3, 4)).gt(0).all())
            and bool(caches["kv"]["k"][:, :, end:].eq(0).all())
            and all(not torch.equal(rows[i], rows[j])
                    for i in range(n_apps) for j in range(i))):
        raise RuntimeError("hybrid: the shared block's KV caches are not "
                           "distinct caches written up to the position")
    log(f"phase 4: hybrid {b} prompts x {s} tokens through ssm_prefill "
        f"({run['prefill_s']!r} s, {run['prefill_s'] / s * 1e3!r} ms per "
        f"token step) + {LLM_NEW} greedy decode steps (ms median "
        f"{float(np.median(run['step_ms']))!r}, min "
        f"{min(run['step_ms'])!r}); ternary_matmul launched "
        f"{run['n_prefill']} + {run['n_decode']} = {per_step} x "
        f"({s} + {LLM_NEW}) token steps; the {n_apps} KV caches written at "
        f"positions 0..{end - 1}, pairwise distinct; first request "
        f"{run['tokens'][0]}; {card}")
    # one more decode step: which weights and which cache each application
    # of the shared block reads, and every kernel-7 call against its plain
    # version on the same input
    apps, body = [], DEC._decode_body

    def body_(h, lp, ck, cv, **kw):
        apps.append((lp is params["shared_attn"], ck.data_ptr(),
                     cv.data_ptr()))
        return body(h, lp, ck, cv, **kw)

    tok = torch.as_tensor([t[-1:] for t in run["tokens"]], device=DEVICE)
    DEC._decode_body = body_
    try:
        with kernel_vs_plain(torch, MM, C) as errs:
            DEC.decode_step(params, tok, caches,
                            torch.full((b,), end, device=DEVICE), cfg)
    finally:
        DEC._decode_body = body
    ptrs = [(caches["kv"]["k"][j].data_ptr(), caches["kv"]["v"][j].data_ptr())
            for j in range(n_apps)]
    if [a[0] for a in apps] != [True] * n_apps or \
            [a[1:] for a in apps] != ptrs:
        raise RuntimeError(f"hybrid: shared block applications {apps}, want "
                           f"{n_apps} on shared_attn over caches {ptrs}")
    log(f"phase 4: hybrid decode step: the {n_apps} applications of the "
        f"shared block all read the one shared_attn dict and write KV caches "
        f"0..{n_apps - 1} in order; kernel 7 against its plain version on "
        f"the same input, max |err| in bf16 ulps of the row's largest "
        f"|output| per (M, K, N): "
        f"{ {k: round(v, 3) for k, v in sorted(errs.items())} } (tolerance "
        f"{SSM_MIXER_ULPS})")
    if max(errs.values()) > SSM_MIXER_ULPS or \
            set(errs) != {(b, k, n) for k, n in projection_shapes(cfg)}:
        raise RuntimeError(f"hybrid: kernel 7 and its plain version differ "
                           f"{errs}")
    del caches, run
    # the decode step above held every projection at M = HYBRID_BATCH;
    # the mixers again over SSM_CHECK_STEPS tokens at M = 1 and 4
    ssm_plain_check(torch, MM, DEC, C, params, cfg,
                    [p[:SSM_CHECK_STEPS] for p in all_prompts], card,
                    label="hybrid", max_len=HYBRID_MAX_LEN)
    ssm_chunked_check(torch, TF, DEC, params, cfg, all_prompts[0],
                      label="hybrid")
    secs, busy = _busy_share(torch, lambda: hybrid_decode(
        torch, MM, DEC, params, cfg, prompts))
    log(f"phase 5: hybrid {cfg.name} prefill + decode under torch.profiler: "
        f"{secs!r} s host clock, device busy {busy!r} s (idle share "
        f"{1 - busy / secs!r}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9!r} GB; {card}")
    return {"launches": per_step * (s + LLM_NEW)}


def encdec_decode(torch, MM, TF, DEC, params, cfg, frames, prompt) -> dict:
    """`TF.encode` of the frames, the cross cache from `TF._xattn_kv` per
    decoder layer, the prompt teacher-forced through `decode_step`, then
    LLM_NEW greedy steps; kernel 7's launches and the host time of each
    part."""
    out: dict = {}
    sync(torch)
    reset_launches(MM)
    t0 = time.perf_counter()
    enc = TF.encode(params, frames, cfg)
    sync(torch)
    out["encode_s"] = time.perf_counter() - t0
    out["n_encode"] = MM.LAUNCHES["ternary_matmul"]
    b = frames.shape[0]
    caches = DEC.init_caches(cfg, b, ENCDEC_MAX_LEN, device=DEVICE)
    reset_launches(MM)
    t0 = time.perf_counter()
    for i, lp in enumerate(params["layers"]):
        k, v = TF._xattn_kv(lp["xattn"], enc, cfg)
        caches["cross"]["k"][i] = k
        caches["cross"]["v"][i] = v
    sync(torch)
    out["cross_s"] = time.perf_counter() - t0
    out["n_cross"] = MM.LAUNCHES["ternary_matmul"]
    reset_launches(MM)
    prompt_ms = []
    for t in range(prompt.shape[1]):
        t0 = time.perf_counter()
        logits, caches = DEC.decode_step(
            params, prompt[:, t:t + 1], caches,
            torch.full((b,), t, dtype=torch.int64, device=DEVICE), cfg)
        sync(torch)
        prompt_ms.append((time.perf_counter() - t0) * 1e3)
    out["n_prompt"] = MM.LAUNCHES["ternary_matmul"]
    out["prompt_logits"] = logits[:, -1, :cfg.vocab].double()
    reset_launches(MM)
    out["tokens"], out["caches"], ms = _greedy(
        torch, DEC, params, cfg, caches, logits, prompt.shape[1], LLM_NEW)
    out["n_decode"] = MM.LAUNCHES["ternary_matmul"]
    out["step_ms"] = prompt_ms + ms
    out["enc"] = enc
    return out


def _layer_increments(torch, MM, C, fn, plain_args, x_at: int):
    """Wrap a layer function whose argument ``x_at`` is its input: each
    call also runs with the plain matmul on the same input
    (``plain_args(args)`` gives the arguments for that run: fresh copies
    of what the layer writes); the returned list gets, per call, the
    largest |err| of the plain run's increment (output minus input) in
    bf16 ulps of the position's largest |increment|."""
    errs = []

    def fn_(*args, **kw):
        again = plain_args(args)
        y = fn(*args, **kw)
        with plain_matmul(MM, C):
            want = fn(*again, **kw)
        h = args[x_at].float()
        errs.append(float(_ulps(torch, y.float() - h, want.float() - h)))
        return y

    return fn_, errs


def k7_times(torch, MM, projs, m, n_layers, card: str, label: str) -> dict:
    """Kernel 7 at M = ``m`` for each (name, packed linear) of one layer:
    ms (CUDA events), device-only ms (torch.profiler), the split-K
    workspace a call allocates, and the library call, bf16
    `torch.matmul` on pre-decoded trits * alpha; the sums over
    ``n_layers`` layers.  The bound: the bytes each call must move (x,
    the packed weights, the scale, the output) or its bf16 operations."""
    from repro_torch.kernels import ref as R

    rng = np.random.default_rng(SEED + 13)
    keys = ("ms", "device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bytes_ms", "ops_ms")
    tot = dict.fromkeys(keys, 0.0)
    for name, p in projs:
        wp, scale = p["w_packed"], p["scale"]
        n = wp.shape[1]
        k = p["k"]
        w_dec = (R.unpack_trits(wp.T).T[:k].to(torch.bfloat16)
                 * scale.to(torch.bfloat16))
        x = torch.as_tensor(rng.standard_normal((m, k)), dtype=torch.float32,
                            device=DEVICE).to(torch.bfloat16)

        def kern():
            return MM.ternary_matmul(x, wp, scale=scale, round_scale=True)

        def lib():
            return torch.matmul(x, w_dec)

        got = {"ms": timed(torch, kern),
               "device_ms": device_ms(torch, kern, "ternary_mm"),
               "plain_ms": timed(torch, lambda: MM.ternary_matmul_plain(
                   x, wp, scale=scale, round_scale=True)),
               "library_ms": timed(torch, lib),
               "library_device_ms": device_ms(torch, lib, ""),
               "bytes_ms": (wp.numel() + 2 * m * k + 2 * m * n + 4 * n)
               / HBM_BYTES_PER_S * 1e3,
               "ops_ms": 2 * m * k * n / BF16_OPS_PER_S * 1e3}
        ws = MM.workspace_bytes(m, k, n, torch.bfloat16)
        for key in keys:
            tot[key] = None if got[key] is None or tot[key] is None else \
                tot[key] + n_layers * got[key]
        log(f"  {label} ternary_matmul {name} ({m}, {k}) x ({k}, {n}): ms "
            f"{got['ms']!r} (device only {got['device_ms']!r}; plain_ms "
            f"{got['plain_ms']!r}), split-K "
            f"workspace {ws} B per call ({MM._plan(k, n, torch.bfloat16)}; "
            f"kept between calls up to {MM.KEEP_WORKSPACE_BYTES} B); "
            f"library torch.matmul bf16 on pre-decoded trits*alpha ms "
            f"{got['library_ms']!r} (device only "
            f"{got['library_device_ms']!r}); bound_ms "
            f"{max(got['bytes_ms'], got['ops_ms'])!r}")
    log(f"phase 5: {label} ternary_matmul at M = {m} summed over {n_layers} "
        f"layers x {len(projs)} projections: ms {tot['ms']!r} (device only "
        f"{tot['device_ms']!r}) plain_ms {tot['plain_ms']!r} library_ms "
        f"{tot['library_ms']!r} (device "
        f"only {tot['library_device_ms']!r}) bound_ms "
        f"{max(tot['bytes_ms'], tot['ops_ms'])!r} (CUDA events, mean of 20 "
        f"after 3 warm-up calls; {card})")
    return tot


def _projs(*named) -> list:
    """(name, packed linear with its logical K) pairs."""
    return [(name, {**p, "k": k}) for name, p, k in named]


def encdec_path(torch, MM, TF, DEC, C, configs, card: str) -> dict:
    """whisper-medium, ternary_packed, at full width and depth with seeded
    weights on the card, through the reference's functions for the family
    (it has no encdec executor): ENCDEC_BATCH seeded utterances of enc_seq
    frames through `encode`, the cross cache from `_xattn_kv` per layer,
    an ENCDEC_PROMPT-token decoder prompt teacher-forced through
    `decode_step`, whose last logits must match `forward_logits` within
    LOGIT_TOL, then LLM_NEW greedy steps: kernel 7 launches 6 x enc_layers
    per encode, 2 x n_layers for the cross cache and 8 x n_layers per
    decode step; each encoder and decoder layer with the plain matmul on
    the kernel run's input within ENCDEC_LAYER_ULPS; kernel 7 at the
    encoder's M against the library call, with its split-K workspace;
    then the host medians, the device's busy share of a profiled run and
    the peak memory."""
    cfg = configs.get(ENCDEC_ARCH).replace(quant="ternary_packed")
    _fresh_peak(torch)
    t0 = time.perf_counter()
    params = llm_params(torch, TF, cfg)
    sync(torch)
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 11)
    frames = torch.randn((ENCDEC_BATCH, cfg.enc_seq, cfg.d_model),
                         generator=gen, device=DEVICE)
    prompt = torch.as_tensor(np.random.default_rng(SEED + 12).integers(
        0, cfg.vocab, (ENCDEC_BATCH, ENCDEC_PROMPT)), device=DEVICE)
    per = {"encode": 6 * cfg.enc_layers, "cross": 2 * cfg.n_layers,
           "step": 8 * cfg.n_layers}
    log(f"phase 4: encdec {cfg.name} ternary_packed ({cfg.enc_layers} "
        f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, MLP {cfg.d_ff} {cfg.act}, vocab {cfg.vocab}): "
        f"parameters {_param_bytes(params) / 1e9!r} GB, drawn in {init_s!r} "
        f"s; kernel 7 per encode 6 x {cfg.enc_layers} = {per['encode']} at "
        f"M = {ENCDEC_BATCH * cfg.enc_seq}, cross cache 2 x {cfg.n_layers} "
        f"= {per['cross']}, per decode step (4 + 2 + 2) x {cfg.n_layers} = "
        f"{per['step']} at M = {ENCDEC_BATCH}; {card}")
    run = encdec_decode(torch, MM, TF, DEC, params, cfg, frames, prompt)
    got = {k: run[f"n_{k}"] for k in ("encode", "cross", "prompt", "decode")}
    want = {"encode": per["encode"], "cross": per["cross"],
            "prompt": per["step"] * ENCDEC_PROMPT,
            "decode": per["step"] * LLM_NEW}
    if DEVICE != "cuda":
        want = dict.fromkeys(want, 0)
    if got != want:
        raise RuntimeError(f"encdec: kernel 7 launched {got}, want {want}")
    full = TF.forward_logits(params, {"tokens": prompt, "frames": frames},
                             cfg)[:, -1, :cfg.vocab].double()
    a = run["prompt_logits"]
    err = float((a - full).abs().max())
    if not (bool(torch.isfinite(a).all()) and err <= LOGIT_TOL):
        raise RuntimeError(f"encdec: the teacher-forced decode's last logits "
                           f"differ from forward_logits by {err} "
                           f"(tolerance {LOGIT_TOL})")
    enc = run.pop("enc")
    if not bool(torch.isfinite(enc).all()) or tuple(enc.shape) != (
            ENCDEC_BATCH, cfg.enc_seq, cfg.d_model):
        raise RuntimeError(f"encdec: encoder output {tuple(enc.shape)}")
    log(f"phase 4: encdec encode of {ENCDEC_BATCH} x {cfg.enc_seq} frames "
        f"{run['encode_s'] * 1e3!r} ms, cross cache {run['cross_s'] * 1e3!r} "
        f"ms, {ENCDEC_PROMPT} teacher-forced + {LLM_NEW} greedy decode steps "
        f"(ms median {float(np.median(run['step_ms']))!r}, min "
        f"{min(run['step_ms'])!r}); ternary_matmul launched {got} = {want}; "
        f"teacher-forced last logits against forward_logits max |err| "
        f"{err!r} (tolerance {LOGIT_TOL}, max |logit| "
        f"{float(full.abs().max())!r}, argmax equal "
        f"{bool((a.argmax(-1) == full.argmax(-1)).all())}); first request "
        f"{run['tokens'][0]}; host clock, {card}")
    # kernel 7 against its plain version, layer by layer on the kernel
    # run's inputs: the encoder at M = batch x enc_seq, then one decode step
    # at M = batch (its KV writes go to copies in the plain run)
    block = TF.dense_block
    TF.dense_block, enc_errs = _layer_increments(torch, MM, C, block,
                                                 lambda a: a, x_at=1)
    try:
        with kernel_vs_plain(torch, MM, C) as enc_calls:
            TF.encode(params, frames, cfg)
    finally:
        TF.dense_block = block
    body = DEC._decode_encdec_body
    DEC._decode_encdec_body, dec_errs = _layer_increments(
        torch, MM, C, body,
        lambda a: (a[0], a[1], a[2].clone(), a[3].clone(), a[4], a[5]),
        x_at=0)
    caches = run["caches"]
    end = ENCDEC_PROMPT + LLM_NEW
    try:
        with kernel_vs_plain(torch, MM, C) as dec_calls:
            DEC.decode_step(params, torch.as_tensor(
                [t[-1:] for t in run["tokens"]], device=DEVICE), caches,
                torch.full((ENCDEC_BATCH,), end, device=DEVICE), cfg)
    finally:
        DEC._decode_encdec_body = body
    calls = {**enc_calls, **dec_calls}
    d, f = cfg.d_model, cfg.d_ff
    shapes = {(m, k, n) for m in (ENCDEC_BATCH * cfg.enc_seq, ENCDEC_BATCH)
              for k, n in ((d, d), (d, f), (f, d))}
    log(f"phase 4: encdec kernel 7 against its plain version, each layer on "
        f"the kernel run's input, max |err| of the layer's increment in "
        f"bf16 ulps of the position's largest |increment|: encoder (M = "
        f"{ENCDEC_BATCH * cfg.enc_seq}) {[round(e, 3) for e in enc_errs]}, "
        f"decoder step (M = {ENCDEC_BATCH}) "
        f"{[round(e, 3) for e in dec_errs]} (tolerance {ENCDEC_LAYER_ULPS}); "
        f"each projection of those runs, max |err| in bf16 ulps of the row's "
        f"largest |output| per (M, K, N): "
        f"{ {k: round(v, 3) for k, v in sorted(calls.items())} } (tolerance "
        f"{SSM_MIXER_ULPS})")
    if len(enc_errs) != cfg.enc_layers or len(dec_errs) != cfg.n_layers \
            or max(enc_errs + dec_errs) > ENCDEC_LAYER_ULPS \
            or set(calls) != shapes or max(calls.values()) > SSM_MIXER_ULPS:
        raise RuntimeError("encdec: kernel 7 and its plain version differ "
                           "in a layer")
    del caches, run
    lp = params["enc_layers"][0]
    m = ENCDEC_BATCH * cfg.enc_seq
    times = k7_times(torch, MM, _projs(
        ("q", lp["attn"]["wq"], d), ("k", lp["attn"]["wk"], d),
        ("v", lp["attn"]["wv"], d), ("o", lp["attn"]["wo"], d),
        ("up", lp["mlp"]["up"], d), ("down", lp["mlp"]["down"], f)),
        m, cfg.enc_layers, card, "encdec encoder")
    secs, busy = _busy_share(torch, lambda: encdec_decode(
        torch, MM, TF, DEC, params, cfg, frames, prompt))
    log(f"phase 5: encdec {cfg.name} encode + decode under torch.profiler: "
        f"{secs!r} s host clock, device busy {busy!r} s (idle share "
        f"{1 - busy / secs!r}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9!r} GB; {card}")
    return {"launches": sum(want.values()), "m": m, "times": times}


def vlm_path(torch, MM, TC, S, TF, DEC, C, configs, card: str) -> dict:
    """llava-next-mistral-7b, ternary_packed, at full width and depth with
    seeded weights on the card: the LLM path's 8 requests through
    CutieEngine + LLMExecutor (text only, as the reference serves vlm):
    kernel 7 launches 7 x n_layers per forward, paged and contiguous give
    the same tokens, one prefill with the plain matmul agrees within
    LOGIT_TOL (`plain_prefill_check`); `forward_loss` under no_grad at
    batch 1 over img_tokens seeded patches and VLM_TEXT text tokens: a
    finite loss within VLM_LOSS_TOL of the plain matmul's, every kernel-7
    call at M = img_tokens + VLM_TEXT within SSM_MIXER_ULPS of its plain
    version; kernel 7 at that M against the library call; then the
    serving times, the device's busy share and the peak memory."""
    cfg = configs.get(VLM_ARCH).replace(quant="ternary_packed",
                                        attn_kv_chunk=16)
    _fresh_peak(torch)
    t0 = time.perf_counter()
    params = llm_params(torch, TF, cfg)
    sync(torch)
    init_s = time.perf_counter() - t0
    per_fwd = 7 * cfg.n_layers
    prompts = llm_prompts(cfg)
    log(f"phase 4: vlm {cfg.name} ternary_packed (d_model {cfg.d_model}, "
        f"{cfg.n_layers} layers, {cfg.n_heads} heads / {cfg.n_kv} kv, MLP "
        f"{cfg.d_ff}, projector {cfg.d_vision} -> {cfg.d_model} bf16): "
        f"parameters {_param_bytes(params) / 1e9!r} GB, drawn in {init_s!r} "
        f"s; kernel 7 per forward 7 x {cfg.n_layers} = {per_fwd}; {card}")
    reset_launches(MM, TC)
    paged = serve(torch, S, params, cfg, prompts)
    sync(torch)
    launches = dict(MM.LAUNCHES)
    st = paged["stats"]["paged_state"]["llm"]
    forwards = st["prefills"] + st["decode_steps"]
    want = per_fwd * forwards if DEVICE == "cuda" else 0
    lens = [len(t) for t in paged["tokens"]]
    if lens != [LLM_NEW] * LLM_REQUESTS:
        raise RuntimeError(f"vlm: token counts {lens}, want {LLM_NEW} each")
    if not st["prefix_hit_rate"] > 0:
        raise RuntimeError(f"vlm: prefix_hit_rate {st['prefix_hit_rate']}")
    if launches["ternary_matmul"] != want or \
            launches["ternary_matmul_dense"] or any(TC.LAUNCHES.values()):
        raise RuntimeError(f"vlm: launches {launches} {TC.LAUNCHES}, want "
                           f"ternary_matmul = {per_fwd} x {forwards} "
                           f"forwards = {want}")
    contiguous = serve(torch, S, params, cfg, prompts, paged=False)
    if contiguous["tokens"] != paged["tokens"]:
        diff = _first_diffs(contiguous["tokens"], paged["tokens"])
        raise RuntimeError(f"vlm: paged and contiguous tokens differ {diff}")
    log(f"phase 4: vlm {LLM_REQUESTS} requests x {LLM_PROMPT} tokens -> "
        f"{LLM_NEW} tokens each; prefix_hit_rate {st['prefix_hit_rate']!r}; "
        f"{st['prefills']} prefills + {st['decode_steps']} decode steps; "
        f"ternary_matmul launched {launches['ternary_matmul']} times "
        f"({per_fwd} x {forwards}); paged and contiguous tokens identical "
        f"(first request {paged['tokens'][0]})")
    plain_prefill_check(torch, MM, DEC, C, params, cfg, prompts[0], "vlm")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 14)
    text = torch.as_tensor(np.random.default_rng(SEED + 15).integers(
        0, cfg.vocab, (1, VLM_TEXT + 1)), device=DEVICE)
    batch = {"tokens": text[:, :-1], "labels": text[:, 1:],
             "patches": torch.randn((1, cfg.img_tokens, cfg.d_vision),
                                    generator=gen, device=DEVICE)}
    m = cfg.img_tokens + VLM_TEXT
    with torch.no_grad():
        reset_launches(MM)
        sync(torch)
        t0 = time.perf_counter()
        loss, metrics = TF.forward_loss(params, batch, cfg)
        sync(torch)
        loss_ms = (time.perf_counter() - t0) * 1e3
        n_loss = MM.LAUNCHES["ternary_matmul"]
        with plain_matmul(MM, C):
            plain_loss, _ = TF.forward_loss(params, batch, cfg)
        with kernel_vs_plain(torch, MM, C) as errs:
            TF.forward_loss(params, batch, cfg)
    err = abs(float(loss) - float(plain_loss))
    log(f"phase 4: vlm forward_loss (no_grad) at batch 1 over "
        f"{cfg.img_tokens} patches + {VLM_TEXT} text tokens (M = {m}): loss "
        f"{float(loss)!r} on {int(metrics['tokens'])} text positions, "
        f"{loss_ms!r} ms; with the plain matmul {float(plain_loss)!r} (|err| "
        f"{err!r}, tolerance {VLM_LOSS_TOL}); ternary_matmul launched "
        f"{n_loss} (7 x {cfg.n_layers}); kernel 7 against its plain version "
        f"on the same input, max |err| in bf16 ulps of the row's largest "
        f"|output| per (M, K, N): "
        f"{ {k: round(v, 3) for k, v in sorted(errs.items())} } (tolerance "
        f"{SSM_MIXER_ULPS}); {card}")
    if not (np.isfinite(float(loss)) and err <= VLM_LOSS_TOL
            and n_loss == (per_fwd if DEVICE == "cuda" else 0)
            and max(errs.values()) <= SSM_MIXER_ULPS
            and set(errs) == {(m, k, n) for k, n in projection_shapes(cfg)}):
        raise RuntimeError("vlm: forward_loss failed its checks")
    lp = params["layers"][0]
    d, f = cfg.d_model, cfg.d_ff
    times = k7_times(torch, MM, _projs(
        ("q", lp["attn"]["wq"], d), ("k", lp["attn"]["wk"], d),
        ("v", lp["attn"]["wv"], d), ("o", lp["attn"]["wo"], d),
        ("gate", lp["mlp"]["gate"], d), ("up", lp["mlp"]["up"], d),
        ("down", lp["mlp"]["down"], f)), m, cfg.n_layers, card, "vlm")
    _serving_line(f"vlm {cfg.name} ternary_packed paged", paged, card)
    _serving_line(f"vlm {cfg.name} ternary_packed contiguous", contiguous,
                  card)
    serving_profile(torch, S, params, cfg, prompts, card,
                    label=f"vlm {cfg.name} ternary_packed paged")
    log(f"phase 5: vlm peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9!r} GB; {card}")
    return {"launches": launches["ternary_matmul"], "m": m, "times": times}


# -- phase 4: the CNN train -> compile -> serve path --------------------------


def _launch_counts(K, FT, TC) -> dict:
    return {"thermometer": TC.LAUNCHES["thermometer"],
            "ternary_conv2d": K.LAUNCHES["ternary_conv2d"],
            "ternary_conv2d_packed": K.LAUNCHES["ternary_conv2d_packed"],
            "fused_trunk": FT.LAUNCHES["fused_trunk"],
            "pack_trits": TC.LAUNCHES["pack_trits"],
            "unpack_trits": TC.LAUNCHES["unpack_trits"]}


def _add_counts(total: dict, part: dict) -> None:
    for k, v in part.items():
        total[k] = total.get(k, 0) + v


def qat_train(torch, Q, CNN, inq) -> dict:
    """`train.cutie_qat.run` at full width on the card: batch 64,
    ``QAT_STEPS`` steps of INQ Magnitude-Inverse (freeze_by 0.75, as the
    reference), ``QAT_EVAL_N`` test images.  The loss must be finite and
    fall, and after the final freeze every effective weight must be a
    trit."""
    rc = Q.QATRunConfig(width=CIFAR_WIDTH, steps=QAT_STEPS, batch=BATCH,
                        eval_n=QAT_EVAL_N, seed=SEED)
    t0 = time.perf_counter()
    result = Q.run(rc, device=DEVICE)
    sync(torch)
    seconds = time.perf_counter() - t0
    hist = result["history"]
    losses = [h["loss"] for h in hist]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"QAT loss history {losses}: want finite and "
                           "falling")
    eff = inq.apply(result["model"].inq_state(),
                    result["params"]["layers"])
    for i, lp in enumerate(eff):
        w = lp["w"]
        if not bool(((w == -1) | (w == 0) | (w == 1)).all()):
            raise RuntimeError(f"layer {i}: effective weights are not "
                               "trits after the final freeze")
    cfg = result["cfg"]
    log(f"phase 4: QAT run on the card: width {cfg.width}, thermometer m "
        f"{cfg.thermometer_m} ({cfg.in_channels} input channels), batch "
        f"{rc.batch}, {rc.steps} steps, INQ {rc.strategy} (freeze_by "
        f"{rc.freeze_by}), {seconds!r} s host clock; loss history "
        f"{[(h['step'], h['loss'], h['acc'], h['inq_frac']) for h in hist]}"
        f" (step, loss, batch acc, frozen share); test accuracy "
        f"{result['accuracy']!r} on {rc.eval_n} images; weight sparsity "
        f"{result['weight_sparsity']!r}; every effective weight a trit")
    return result


def qat_step_card_vs_cpu(torch, Q, CNN, adam, cifar, configs_cnn) -> None:
    """One training step at width ``STEP_CHECK_WIDTH`` (batch 16) from
    the same weights and the same 20%-frozen INQ state on the card and on
    the CPU, TF32 switched off around it (and restored): the loss within
    ``STEP_LOSS_RTOL``, the gradient norm within ``STEP_GN_RTOL``, every
    updated tensor within ``STEP_ATOL`` except where a gradient's sign
    flipped (at most ``STEP_FLIP_SHARE`` of the weights, each by at most
    the step's bound 2 * lr + ``STEP_ATOL``)."""
    cfg = configs_cnn.CutieCNNConfig(width=STEP_CHECK_WIDTH)
    rc = Q.QATRunConfig(width=STEP_CHECK_WIDTH, steps=QAT_STEPS)
    icfg, acfg = Q.inq_config(rc), Q.adam_config(rc)
    cpu = CNN.CutieCNN(cfg, seed=SEED, device="cpu")
    card = copy.deepcopy(cpu).to(DEVICE)
    for m in (cpu, card):
        Q.freeze(m, 0.2, icfg)
    for a, b in zip(cpu.inq_state(), card.inq_state()):
        for f in ("mask", "q"):
            if not torch.equal(a["w"][f], b["w"][f].cpu()):
                raise RuntimeError(f"INQ {f} on the card differs from the "
                                   "CPU's")
    data = cifar.SynthCifarConfig()
    bc = cifar.encoded_batch(data, "train", 0, 16, device="cpu")
    bg = cifar.encoded_batch(data, "train", 0, 16, device=DEVICE)
    if not torch.equal(bc["x"], bg["x"].cpu()):
        raise RuntimeError("encoded_batch on the card differs from the CPU's")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, mc = Q.train_step(cpu, adam.init_state(cpu.trainable()), bc, acfg)
        _, mg = Q.train_step(card, adam.init_state(card.trainable()), bg,
                             acfg)
        sync(torch)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    lc, lg = float(mc["loss"]), float(mg["loss"])
    gc, gg = float(mc["grad_norm"]), float(mg["grad_norm"])
    if abs(lc - lg) > STEP_LOSS_RTOL * abs(lc) or \
            abs(gc - gg) > STEP_GN_RTOL * abs(gc):
        raise RuntimeError(f"card step loss {lg!r} / grad norm {gg!r} vs "
                           f"CPU {lc!r} / {gc!r}")
    far = total = 0
    worst = 0.0
    for (name, a), b in zip(cpu.state_dict().items(),
                            card.state_dict().values()):
        d = (a - b.cpu()).abs()
        worst = max(worst, float(d.max()))
        if float(d.max()) > 2 * acfg.lr + STEP_ATOL:
            raise RuntimeError(f"{name}: card step differs by "
                               f"{float(d.max())!r}")
        far += int((d > STEP_ATOL).sum())
        total += d.numel()
    if far > STEP_FLIP_SHARE * total:
        raise RuntimeError(f"{far} of {total} updated values differ by more "
                           f"than {STEP_ATOL}")
    log(f"phase 4: one QAT step at width {STEP_CHECK_WIDTH} (TF32 off), card "
        f"vs CPU: loss {lg!r} vs {lc!r}, grad norm {gg!r} vs {gc!r}, "
        f"updated tensors max abs diff {worst!r}, {far} of {total} values "
        f"past {STEP_ATOL}; INQ masks, frozen trits and encoded batch "
        "identical")


def qat_compile(torch, K, FT, TC, P, Q, engine, compiler, ops, result, x
                ) -> tuple:
    """`cutie_qat.compile(result, include_head=True, optimize=True)` on
    the card, then on ``cuda``, ``packed``, ``fused`` and a two-trunk
    ``fused`` split, equal to ``ref`` (`every_backend`); the codec entry
    points on the split's boundary; the QAT graph's argmax against the
    compiled head-less pipeline's (``AGREE_FLOOR``).  Returns the
    compiled result and this sub-phase's launches."""
    compiled = Q.compile(result, include_head=True, optimize=True)
    prog = compiled.program
    cpu_model = copy.deepcopy(result["model"]).to("cpu")
    bad = same_program(torch, prog, Q.compile(
        dict(result, model=cpu_model), include_head=True,
        optimize=True).program)
    if bad:
        raise RuntimeError(f"the trained program compiled on the card "
                           f"differs from its compile on the CPU: {bad}")
    log(f"phase 4: cutie_qat.compile of the trained run with its head "
        f"(optimize=True): {len(prog.layers)} layers, channels "
        f"{[li.weights.shape[-1] for li in prog.layers]}, folded "
        f"{compiled.folded_channels}, removed {compiled.removed_channels}, "
        f"ops reduction {compiled.ops_reduction!r}; equal to its compile "
        "on the CPU array for array")
    budget = compiler.trunk_l2_bytes(prog.layers[:SPLIT_AT], tuple(x.shape))
    runs = every_backend(torch, K, FT, P, compiled, x, budget,
                         "trained CIFAR-10 + head")
    launches = {"fused_trunk": runs["fused"][0] + runs["fused-split"][0],
                "ternary_conv2d": (runs["cuda"][1] + runs["fused"][1]
                                   + runs["fused-split"][1]),
                "ternary_conv2d_packed": runs["packed"][2]}
    _, codec_launches = boundary_codec(torch, FT, TC, P, engine, ops, prog,
                                       x, "the trained")
    launches.update(codec_launches)
    model = result["model"]
    feats = P.CutiePipeline(Q.to_program(result), backend="fused",
                            device=DEVICE).run(x)
    with torch.no_grad():
        logits, _ = model(x.to(torch.float32), train=False, inq=True)
        eng = feats.reshape(x.shape[0], -1).to(torch.float32) @ model.fc
    agree = float((logits.argmax(-1) == eng.argmax(-1)).float().mean())
    if agree < AGREE_FLOOR:
        raise RuntimeError(f"QAT-graph vs pipeline argmax agreement {agree}"
                           f" < {AGREE_FLOOR}")
    log(f"phase 4: trained program: QAT-graph vs bit-true pipeline argmax "
        f"agreement {agree!r} on {x.shape[0]} test images (floor "
        f"{AGREE_FLOOR}; the QAT forward's pre-activations in float64)")
    return compiled, launches


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def cnn_checkpoint(torch, TC, Q, CNN, result, compiled) -> None:
    """`checkpoint.save` of the trained full-width run (its params and
    INQ state, the reference's trees) and of its compiled program (the
    int8 trit weights and constants: ``trit5`` leaves, packed on the card
    by kernel 4 before their copy to the host), then `checkpoint.restore`
    onto the card (kernel 5 unpacks them there): the restored params in
    a fresh model must compile to the same program, and the restored
    program's arrays must equal the program's."""
    from repro_torch import checkpoint as ckpt

    model, prog = result["model"], compiled.program
    tree = {"params": model.params(), "inq_state": model.inq_state(),
            "program": [{"weights": li.weights,
                         **{f: getattr(li.thresholds, f) for f in (
                             "t_lo", "t_hi", "flip", "const", "is_const")}}
                        for li in prog.layers]}
    n_trit = 2 * len(prog.layers)              # weights and const per layer
    with tempfile.TemporaryDirectory() as root:
        reset_launches(TC)
        sync(torch)
        t0 = time.perf_counter()
        path = ckpt.save(root, QAT_STEPS, tree)
        save_s = time.perf_counter() - t0
        saved = dict(TC.LAUNCHES)
        nbytes = _dir_bytes(path)
        reset_launches(TC)
        t0 = time.perf_counter()
        back, _ = ckpt.restore(root, tree)
        sync(torch)
        restore_s = time.perf_counter() - t0
        restored = dict(TC.LAUNCHES)
    if DEVICE == "cuda" and (saved["pack_trits"], restored["unpack_trits"]
                             ) != (n_trit, n_trit):
        raise RuntimeError(f"checkpoint codec launches: save {saved}, "
                           f"restore {restored}; want {n_trit} each")
    fresh = CNN.CutieCNN(model.cfg, seed=SEED + 99, device=DEVICE)
    with torch.no_grad():
        for b, lp in zip(fresh.layers, back["params"]["layers"]):
            for f in ("w", "gamma", "beta", "mean", "var"):
                getattr(b, f).copy_(lp[f])
        fresh.fc.copy_(back["params"]["fc"])
    fresh.load_inq_state(back["inq_state"])
    again = Q.compile(dict(result, model=fresh), include_head=True,
                      optimize=True).program
    bad = same_program(torch, again, prog)
    for i, (li, lt) in enumerate(zip(prog.layers, back["program"])):
        if not torch.equal(li.weights, lt["weights"]):
            bad.append(f"restored program layer {i} weights")
        for f in ("t_lo", "t_hi", "flip", "const", "is_const"):
            a, b = getattr(li.thresholds, f), lt[f]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                bad.append(f"restored program layer {i} {f}")
    if bad:
        raise RuntimeError(f"checkpoint round trip of the trained run: {bad}")
    log(f"phase 4: checkpoint.save of the trained CIFAR-10 run (params, INQ "
        f"state and its {len(prog.layers)}-layer program) {save_s * 1e3!r} "
        f"ms, restore onto the card {restore_s * 1e3!r} ms (host clock), "
        f"{nbytes} bytes on disk; kernel 4 launched {saved['pack_trits']} "
        f"times in the save, kernel 5 {restored['unpack_trits']} in the "
        "restore (one per trit leaf); the restored params compile to the "
        "same program and the restored program equals it")


def serve_pool(torch, cifar, P, compiled) -> dict:
    """``SERVE_POOL`` synthcifar test images encoded by kernel 6 on the
    card (one launch), their int8 trits on the host for submit, and the
    ``ref`` backend's output for each: the oracle of every response."""
    b = cifar.encoded_batch(cifar.SynthCifarConfig(), "test", 0, SERVE_POOL,
                            device=DEVICE)
    x = b["x"].to(torch.int8)
    ref = P.CutiePipeline(compiled.program, backend="ref",
                          device=DEVICE).run(x)
    return {"x": x, "imgs": list(x.cpu().numpy()),
            "ref": list(ref.cpu().numpy())}


def _serve_engine(S, P, compiled, scheduler: str, **kw):
    """One engine serving the trained program as ``cnn-cuda`` (with a
    SwitchingTracer) and ``cnn-fused``, buckets ``SERVE_BUCKETS``."""
    eng = S.CutieEngine(scheduler, **kw)
    eng.register("cnn-cuda", compiled, backend="cuda", device=DEVICE,
                 buckets=SERVE_BUCKETS, tracer=P.SwitchingTracer())
    eng.register("cnn-fused", compiled, backend="fused", device=DEVICE,
                 buckets=SERVE_BUCKETS)
    return eng


def _calibrate_batch(torch, S, P, compiled, pool) -> float:
    """Seconds per full-bucket engine step (every bucket warmed first),
    the median of 3 on each model, the larger of the two."""
    worst = 0.0
    for model in ("cnn-cuda", "cnn-fused"):
        eng = _serve_engine(S, P, compiled, "fcfs")
        for b in SERVE_BUCKETS:
            for i in range(b):
                eng.submit(pool["imgs"][i], model=model)
            eng.run()
        ts = []
        for _ in range(3):
            for i in range(SERVE_BUCKETS[-1]):
                eng.submit(pool["imgs"][i], model=model)
            t0 = time.perf_counter()
            eng.step()
            ts.append(time.perf_counter() - t0)
        worst = max(worst, float(np.median(ts)))
    return worst


def _load_trace(rate: float) -> list:
    """The seeded open-loop Poisson trace: ``SERVE_REQUESTS`` arrivals at
    ``rate`` per second, 25% interactive, each on one of the two models
    and one pool image."""
    rng = np.random.default_rng(SEED + 20)
    t = np.cumsum(rng.exponential(1.0 / rate, size=SERVE_REQUESTS))
    return [{"t": float(t[i]), "img": int(rng.integers(SERVE_POOL)),
             "model": ("cnn-cuda", "cnn-fused")[int(rng.integers(2))],
             "interactive": bool(rng.random() < INTERACTIVE_FRAC)}
            for i in range(SERVE_REQUESTS)]


def _drive_load(eng, trace, pool, target: float, loose: float) -> list:
    """Open-loop replay: submit at trace times, step while busy."""
    handles, i, t0 = [], 0, time.perf_counter()
    while i < len(trace) or eng.busy():
        now = time.perf_counter() - t0
        while i < len(trace) and trace[i]["t"] <= now:
            a = trace[i]
            handles.append((a, eng.submit(
                pool["imgs"][a["img"]], model=a["model"],
                priority=int(a["interactive"]),
                deadline=target if a["interactive"] else loose,
                tag="interactive" if a["interactive"] else "batch")))
            i += 1
        if eng.busy():
            if not eng.step():
                raise RuntimeError("engine busy but made no progress")
        elif i < len(trace):
            time.sleep(min(max(trace[i]["t"] - now, 0.0), 1e-3))
    return handles


def serve_buckets(torch, K, FT, TC, S, P, compiler, compiled, pool
                  ) -> dict:
    """Every serving bucket on every backend: the trained program
    registered alone with buckets ``(b,)`` on ``cuda``, ``packed``,
    ``fused`` and a two-trunk ``fused`` split serves 8 pool images, each
    response equal to ``ref``'s, every batch padded to ``b``, one program
    variant.  Returns this sub-phase's launches."""
    prog = compiled.program
    reset_launches(K, FT, TC)
    for b in SERVE_BUCKETS:
        shape = (b,) + tuple(pool["x"].shape[1:])
        split = P.FusedBackend(l2_budget=compiler.trunk_l2_bytes(
            prog.layers[:SPLIT_AT], shape))
        for label, backend in (("cuda", "cuda"), ("packed", "packed"),
                               ("fused", "fused"), ("fused-split", split)):
            eng = S.CutieEngine("fcfs")
            ex = eng.register("m", compiled, backend=backend, device=DEVICE,
                              buckets=(b,))
            hs = [eng.submit(pool["imgs"][i], model="m") for i in range(8)]
            eng.run()
            bad = [i for i, h in enumerate(hs) if not np.array_equal(
                h.request.result, pool["ref"][i])]
            if bad or {x["padded"] for x in eng.batches} != {b} or \
                    ex.n_jit_variants != 1:
                raise RuntimeError(f"bucket {b} on {label}: responses {bad} "
                                   "differ from ref, or batches/variants "
                                   "are off")
    sync(torch)
    launches = _launch_counts(K, FT, TC)
    log(f"phase 4: every bucket {SERVE_BUCKETS} on cuda, packed, fused and "
        "fused-split (8 images each): responses equal to ref's, one "
        f"program variant each; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def cnn_serve(torch, K, FT, TC, S, P, compiled, pool) -> dict:
    """The trained program served through `CutieEngine` + the port's
    `ProgramExecutor` on ``cuda`` and ``fused``: calibrated capacity, then
    the open-loop trace at ``OVERLOAD`` x capacity under ``fcfs`` and
    ``deadline``.  Every response must equal ``ref``'s bit for bit, every
    handle must finish, and each model's program variants stay within its
    buckets.  Returns the runs and this sub-phase's launches."""
    t_batch = _calibrate_batch(torch, S, P, compiled, pool)
    rate = OVERLOAD * SERVE_BUCKETS[-1] / t_batch
    trace = _load_trace(rate)
    target, loose = TARGET_MULT * t_batch, BATCH_DEADLINE_MULT * t_batch
    reset_launches(K, FT, TC)
    out = {"t_batch": t_batch, "rate": rate, "target": target}
    for sched in ("fcfs", "deadline"):
        eng = _serve_engine(S, P, compiled, sched)
        t0 = time.perf_counter()
        handles = _drive_load(eng, trace, pool, target, loose)
        wall = time.perf_counter() - t0
        bad = [a for a, h in handles if h.status is not S.RequestStatus.DONE
               or not np.array_equal(h.request.result, pool["ref"][a["img"]])]
        st = eng.stats()
        if bad or len(handles) != SERVE_REQUESTS:
            raise RuntimeError(f"serve under {sched}: {len(bad)} responses "
                               "unfinished or unequal to ref")
        if any(v > len(SERVE_BUCKETS) for v in st["jit_variants"].values()):
            raise RuntimeError(f"jit_variants {st['jit_variants']} exceed "
                               f"{len(SERVE_BUCKETS)} buckets")
        out[sched] = {"stats": st, "wall": wall}
    sync(torch)
    launches = _launch_counts(K, FT, TC)
    log(f"phase 4: CNN serve of the trained program (cnn-cuda with a "
        f"SwitchingTracer, cnn-fused; buckets {SERVE_BUCKETS}): "
        f"{SERVE_REQUESTS} requests under fcfs and under deadline at "
        f"{rate!r} req/s ({OVERLOAD} x the capacity of a {t_batch!r} s "
        "full-bucket step), 25% interactive: every response equal to ref's "
        f"bit for bit; jit_variants {out['deadline']['stats']['jit_variants']}"
        f"; energy_uj {out['deadline']['stats']['energy_uj']!r} (NaN: the "
        "head's one-window map); launches in the serves "
        f"{ {k: v for k, v in launches.items() if v} }")
    return out, launches


def cnn_faults(torch, S, P, compiled, pool) -> None:
    """`benchmarks/fault_injection.py` scenarios 1 and 2 on the trained
    program: chaos over a `FaultyExecutor` wrapping the ``fused``
    `ProgramExecutor`, with a ``cuda`` fallback serving the same program
    (no request lost, survivors equal ref's, poison isolated, quarantine
    fired); then a burst past ``max_queue_depth`` (shedding caps the
    queue, everything admitted completes)."""
    n = 48
    rng = np.random.default_rng(SEED + 21)
    t = np.cumsum(rng.exponential(1.0 / 0.7, size=n))
    trace = [{"t": float(t[i]), "tag": f"i{i}",
              "img": int(rng.integers(SERVE_POOL))} for i in range(n)]
    plan = S.FaultPlan(seed=SEED, raise_rate=0.12, slow_rate=0.05,
                       nan_rate=0.08, poison_rate=0.08, slow_s=0.005,
                       device_loss_at=12, device_loss_calls=6,
                       start_after=2)
    policy = S.FaultPolicy(max_retries=5, backoff_base=0.001,
                           backoff_cap=0.01, quarantine_after=5)
    eng = S.CutieEngine("fcfs", policy=policy)
    eng.register("backup", compiled, backend="cuda", device=DEVICE,
                 buckets=(1, 2, 4))
    faulty = S.FaultyExecutor(S.ProgramExecutor(
        compiled.pipeline("fused", device=DEVICE), buckets=(1, 2, 4)), plan)
    eng.register("cnn", faulty, fallback="backup")
    handles, i, steps = {}, 0, 0
    while i < n or eng.busy():
        while i < n and trace[i]["t"] <= steps:
            handles[trace[i]["tag"]] = (trace[i], eng.submit(
                pool["imgs"][trace[i]["img"]], model="cnn",
                tag=trace[i]["tag"]))
            i += 1
        if eng.busy() and not eng.step():
            raise RuntimeError("chaos: engine busy but made no progress")
        steps += 1
        if steps > 100_000:
            raise RuntimeError("chaos trace did not drain")
    poisoned = {x["tag"] for x in trace if plan.poisoned(x["tag"])}
    terminal = (S.RequestStatus.DONE, S.RequestStatus.CANCELLED,
                S.RequestStatus.FAILED)
    done = {k: (a, h) for k, (a, h) in handles.items()
            if h.status is S.RequestStatus.DONE}
    faults = eng.stats()["faults"]
    checks = {
        "no_request_lost": len(handles) == n and all(
            h.status in terminal for _, h in handles.values()),
        "survivors_bitexact": bool(done) and all(
            np.array_equal(h.request.result, pool["ref"][a["img"]])
            for a, h in done.values()),
        "poison_isolated": all(h.status is S.RequestStatus.DONE
                               for k, (_, h) in handles.items()
                               if k not in poisoned),
        "quarantine_fired": faults["n_quarantines"] >= 1,
    }
    shed_eng = S.CutieEngine("fcfs", policy=S.FaultPolicy(max_queue_depth=3))
    shed_eng.register("cnn", compiled, backend="fused", device=DEVICE,
                      buckets=(1,))
    admitted, shed = [], 0
    for k in range(10):
        try:
            admitted.append(shed_eng.submit(pool["imgs"][k], model="cnn"))
        except S.LoadShedError:
            shed += 1
    shed_eng.run()
    checks["shedding_caps_queue"] = shed > 0 and len(admitted) <= 3
    checks["shed_admitted_complete"] = all(
        h.status is S.RequestStatus.DONE for h in admitted)
    if not all(checks.values()):
        raise RuntimeError(f"fault injection checks failed: {checks}")
    log(f"phase 4: fault injection on the trained program: chaos {n} "
        f"requests ({len(poisoned)} poisoned), {len(done)} done, injected "
        f"{dict(faulty.injected)}, retries {faults['n_retries']}, "
        f"quarantines {faults['n_quarantines']}, rerouted "
        f"{faults['n_rerouted']}; shed {shed} of 10 at max_queue_depth 3; "
        f"checks {checks}")


def cnn_main_path(torch, K, FT, TC, P, S, Q, CNN, inq, adam, cifar,
                  configs_cnn, engine, compiler, ops) -> dict:
    """The third main path, train -> compile -> serve, driven with every
    launch count set to 0 just before each sub-phase and read just after;
    every kernel of the path must have launched."""
    reset_launches(K, FT, TC)
    result = qat_train(torch, Q, CNN, inq)
    sync(torch)
    launches = _launch_counts(K, FT, TC)
    want_thermo = QAT_STEPS + -(-QAT_EVAL_N // 128)
    if launches["thermometer"] != want_thermo and DEVICE == "cuda":
        raise RuntimeError(f"training launched the thermometer kernel "
                           f"{launches['thermometer']} times, want "
                           f"{want_thermo} (one per training and eval batch)")
    qat_step_card_vs_cpu(torch, Q, CNN, adam, cifar, configs_cnn)
    reset_launches(TC)
    x = cifar.encoded_batch(cifar.SynthCifarConfig(), "test", 0, BATCH,
                            device=DEVICE)["x"].to(torch.int8)
    sync(torch)
    _add_counts(launches, {"thermometer": TC.LAUNCHES["thermometer"]})
    compiled, part = qat_compile(torch, K, FT, TC, P, Q, engine, compiler,
                                 ops, result, x)
    _add_counts(launches, part)
    reset_launches(TC)
    cnn_checkpoint(torch, TC, Q, CNN, result, compiled)
    _add_counts(launches, {k: TC.LAUNCHES[k] for k in ("pack_trits",
                                                      "unpack_trits")})
    reset_launches(TC)
    pool = serve_pool(torch, cifar, P, compiled)
    sync(torch)
    _add_counts(launches, {"thermometer": TC.LAUNCHES["thermometer"]})
    _add_counts(launches, serve_buckets(torch, K, FT, TC, S, P, compiler,
                                        compiled, pool))
    served, part = cnn_serve(torch, K, FT, TC, S, P, compiled, pool)
    _add_counts(launches, part)
    cnn_faults(torch, S, P, compiled, pool)
    missing = [k for k, v in launches.items() if not v]
    if missing and DEVICE == "cuda":
        raise RuntimeError(f"train -> compile -> serve launched no {missing}")
    log(f"phase 4: train -> compile -> serve launches per kernel {launches}")
    return {"result": result, "compiled": compiled, "x": x, "pool": pool,
            "served": served, "launches": launches}


# -- phase 5: timing ---------------------------------------------------------


def program_latency(torch, P, mp, card: str, reps: int = 10) -> None:
    """Host-clock ms per `run` and `measure` of the whole compiled
    program (the CIFAR-10 network with its head), ending in a
    synchronize: what a caller of the pipeline waits for; beside it the
    host time until the call returns, before the synchronize (the enqueue
    cost, where nothing in the call waits for the card)."""
    prog, x = mp["compiled"], mp["x"]
    backends = {"ref": "ref", "cuda": "cuda", "packed": "packed",
                "fused": "fused",
                "fused-split": P.FusedBackend(l2_budget=mp["split_budget"])}
    for label, backend in backends.items():
        pipe = P.CutiePipeline(prog, backend=backend)
        for what, fn in (("run", lambda: pipe.run(x)),
                         ("measure", lambda: pipe.measure(x))):
            fn()
            torch.cuda.synchronize()
            ts, enq = [], []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                enq.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            log(f"phase 5: program {what} on {label!r}, batch {BATCH}: "
                f"median ms {float(np.median(ts))!r} (min "
                f"{min(ts)!r}, max {max(ts)!r}, {reps} runs, host clock; "
                f"host returns after median {float(np.median(enq))!r} ms; "
                f"{card})")


def timed(torch, fn, reps: int = 20) -> float:
    """Mean ms per call over ``reps`` calls after a warm-up, CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, name_part: str, reps: int = 10, tries: int = 3):
    """Mean device time in ms per call of ``fn`` of the kernels whose name
    holds ``name_part``, from a torch.profiler trace (CUPTI); None when
    ``tries`` traces show no such kernel (a trace now and then comes back
    empty)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if name_part in e.key)
        if us:
            return us / reps / 1e3
    return None


def _record(name, launches, worst, ms, plain_ms, bytes_ms, ops_ms,
            library_ms) -> dict:
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms}


def time_kernels(torch, F, K, codec, engine, mp, card: str,
                 worst: dict) -> tuple[list[dict], dict]:
    """The conv kernels layer by layer: caller-visible ms (CUDA events),
    device-only ms (torch.profiler), the plain version and two library
    yardsticks, f16 channels-last `F.conv2d` (tensor cores; its output
    must equal the kernel's raw int32 output, or the run fails) and f32
    `F.conv2d` with TF32 off (CUDA cores).  Returns the records and the
    summed yardsticks (8 calls each)."""
    prog, x = mp["program"], mp["x"]
    acts, cur = [], x
    for instr in prog.layers:                  # each layer's real input
        acts.append(cur)
        th = instr.thresholds
        cur = K.ternary_conv2d_plain(
            cur, instr.weights, stride=instr.stride, padding=instr.padding,
            t_lo=th.t_lo, t_hi=th.t_hi, flip=th.flip, const=th.const,
            is_const=th.is_const, pool=instr.pool)
    names = ("ternary_conv2d", "ternary_conv2d_packed")
    keys = ("ms", "device_ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms")
    totals = {name: dict.fromkeys(keys, 0.0) for name in names}
    lib = dict.fromkeys(("f16_ms", "f16_device_ms", "f32_ms"), 0.0)
    log(f"phase 5: per-layer ms at batch {BATCH} on {card} "
        "(CUDA events, mean of 20 after 3 warm-up calls, L2 warm; device "
        "only from torch.profiler, mean of 10)")
    for li, (instr, a) in enumerate(zip(prog.layers, acts)):
        th = instr.thresholds
        conv = dict(stride=instr.stride, padding=instr.padding)
        ep = dict(conv, t_lo=th.t_lo, t_hi=th.t_hi, flip=th.flip,
                  const=th.const, is_const=th.is_const, pool=instr.pool)
        w = instr.weights
        k, _, cin, cout = w.shape
        wp = codec.pack_filter_rows(w)
        n, h, wd, _ = a.shape
        oh, ow = engine.conv_out_hw(instr, h, wd)
        ph, pw = ((oh // instr.pool[1], ow // instr.pool[1]) if instr.pool
                  else (oh, ow))
        ops = 2 * n * oh * ow * k * k * cin * cout
        lib_args = dict(stride=instr.stride,
                        padding=k // 2 if instr.padding else 0)
        xf = a.permute(0, 3, 1, 2).float()
        wf = w.permute(3, 2, 0, 1).float()
        # trits and sums up to 9 x 128 = 1,152 < 2,048 are exact in f16
        xh = a.permute(0, 3, 1, 2).half()        # NHWC memory: channels last
        wh = w.permute(3, 2, 0, 1).half().contiguous(
            memory_format=torch.channels_last)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f32_ms = timed(torch, lambda: F.conv2d(xf, wf, **lib_args))
            f16 = lambda: F.conv2d(xh, wh, **lib_args)  # noqa: E731
            z16 = f16().permute(0, 2, 3, 1).to(torch.int32)
            raw = K.ternary_conv2d(a, w, **conv)
            sync(torch)
            if not torch.equal(z16, raw):
                raise RuntimeError(
                    f"layer {li}: f16 F.conv2d differs from the kernel's raw "
                    f"int32 output by {_err(torch, z16, raw)}: the yardstick "
                    "does not compute the same integers")
            f16_ms = timed(torch, f16)
            f16_dev = device_ms(torch, f16, "")
        lib["f16_ms"] += f16_ms
        lib["f32_ms"] += f32_ms
        lib["f16_device_ms"] = (None if f16_dev is None
                                or lib["f16_device_ms"] is None
                                else lib["f16_device_ms"] + f16_dev)
        calls = {
            "ternary_conv2d": (lambda: K.ternary_conv2d(a, w, **ep),
                               lambda: K.ternary_conv2d_plain(a, w, **ep),
                               w.numel()),
            "ternary_conv2d_packed": (
                lambda: K.ternary_conv2d_packed(a, wp, k=k, cin=cin, **ep),
                lambda: K.ternary_conv2d_packed_plain(a, wp, k=k, cin=cin,
                                                      **ep),
                wp.numel()),
        }
        for name, (kern, plain, wbytes) in calls.items():
            nbytes = a.numel() + wbytes + 11 * cout + n * ph * pw * cout
            t = totals[name]
            ms, pms = timed(torch, kern), timed(torch, plain)
            dev = device_ms(torch, kern, "conv_")
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops / INT8_OPS_PER_S * 1e3
            for key, v in (("ms", ms), ("device_ms", dev), ("plain_ms", pms),
                           ("bytes_ms", b_ms), ("ops_ms", o_ms),
                           ("bound_ms", max(b_ms, o_ms))):
                t[key] = None if v is None or t[key] is None else t[key] + v
            log(f"  layer {li} {name}: {tuple(a.shape)} -> "
                f"({n}, {ph}, {pw}, {cout}) ms {ms!r} (device only {dev!r}) "
                f"plain_ms {pms!r} library f16 ms {f16_ms!r} (device only "
                f"{f16_dev!r}) f32 ms {f32_ms!r} bound_ms "
                f"{max(b_ms, o_ms)!r} ({ops} ops, {nbytes} B)")
    out = []
    for name, t in totals.items():
        rec = _record(name, mp["launches"][name], worst[name], t["ms"],
                      t["plain_ms"], t["bytes_ms"], t["ops_ms"],
                      lib["f16_ms"])
        rec["bound_ms"] = t["bound_ms"]       # 8 launches: sum of bounds
        rec.update(device_ms=t["device_ms"],
                   library_device_ms=lib["f16_device_ms"],
                   library_f32_ms=lib["f32_ms"], library_call=LIBRARY_CONV)
        out.append(rec)
        log(f"phase 5: {name} over the 8 layers: ms {t['ms']!r} (device "
            f"only {t['device_ms']!r}) plain_ms {t['plain_ms']!r} library "
            f"f16 ms {lib['f16_ms']!r} (device only {lib['f16_device_ms']!r})"
            f" f32 ms {lib['f32_ms']!r} bound_ms {rec['bound_ms']!r} "
            f"({card})")
    return out, lib


def time_new_kernels(torch, FT, TC, mp, llm, card: str, worst: dict,
                     conv_lib: dict) -> list[dict]:
    """The trunk kernel on the whole program, the codec on the split's
    boundary and in its KV forms at the trit serve's shapes, and the
    thermometer on the CIFAR input, beside their bounds."""
    prog, x = mp["program"], mp["x"]
    layers = prog.layers
    ops_args = _trunk_operands(torch, layers)
    metas = tuple((li.stride, li.pool) for li in layers)
    trunk = (lambda: FT.fused_trunk(x, *ops_args, metas=metas))
    plain = (lambda: FT.fused_trunk_plain(x, *ops_args, metas=metas))
    ops = sum(2 * BATCH * h * w * 9 * li.weights.shape[2]
              * li.weights.shape[3] for li, (h, w) in
              zip(layers, FT.trunk_shapes((CIFAR_HW, CIFAR_HW), 3,
                                          metas)))
    nl = len(layers)
    nbytes = (x.numel() + ops_args[0].numel() + 11 * nl * CIFAR_WIDTH
              + BATCH * CIFAR_WIDTH)
    ms, pms = timed(torch, trunk), timed(torch, plain)
    dev = device_ms(torch, trunk, "trunk")
    out = [_record("fused_trunk", mp["launches"]["fused_trunk"],
                   worst["fused_trunk"], ms, pms,
                   nbytes / HBM_BYTES_PER_S * 1e3,
                   ops / INT8_OPS_PER_S * 1e3, conv_lib["f16_ms"])]
    out[-1].update(device_ms=dev,
                   library_device_ms=conv_lib["f16_device_ms"],
                   library_f32_ms=conv_lib["f32_ms"],
                   library_call=LIBRARY_CONV)
    log(f"phase 5: fused_trunk, whole program in one launch at batch "
        f"{BATCH}: ms {ms!r} (device only {dev!r}) plain_ms {pms!r} "
        f"bound_ms {out[-1]['bound_ms']!r} ({ops} ops, {nbytes} B); library "
        f"yardsticks, 8 F.conv2d calls summed: f16 channels-last "
        f"{conv_lib['f16_ms']!r} ms (device only "
        f"{conv_lib['f16_device_ms']!r}), f32 {conv_lib['f32_ms']!r} ms "
        f"({card})")
    for stats in (False, True):
        trunk_timeline(torch, FT, x, ops_args, metas, stats, card)
    trunk_host_breakdown(torch, FT, x, ops_args, metas, card)
    b = mp["boundary"].reshape(1, -1)
    packed = TC.pack_trits(b)
    log(f"phase 5: codec and thermometer kernels on {card}: ms per call "
        "(CUDA events, mean of 20 after 3 warm-up calls), device only "
        "(torch.profiler, mean of 10), wrapper host us per call (50 calls, "
        "no synchronize)")
    cases = {      # (kernel, plain, bytes moved, shape, profiler name)
        "pack_trits": (lambda: TC.pack_trits(b),
                       lambda: TC.pack_trits_plain(b),
                       b.numel() + packed.numel(), tuple(b.shape),
                       "pack_flat_kernel"),
        "unpack_trits": (lambda: TC.unpack_trits(packed),
                         lambda: TC.unpack_trits_plain(packed),
                         packed.numel() * 6, tuple(packed.shape),
                         "unpack_kernel"),
    }
    recs = {}
    for name, (kern, plain, nbytes, shape, part) in cases.items():
        ms, pms = timed(torch, kern), timed(torch, plain)
        dev, hus = device_ms(torch, kern, part), host_us(torch, kern)
        rec = _record(name, mp["launches"][name], worst[name], ms, pms,
                      nbytes / HBM_BYTES_PER_S * 1e3, 0.0, None)
        rec.update(shape=shape, device_ms=dev, host_us_per_call=hus)
        out.append(rec)
        recs[name] = rec
        log(f"phase 5: {name} on {shape}: ms {ms!r} (device only {dev!r}; "
            f"host us per call {hus!r}) plain_ms {pms!r} bound_ms "
            f"{rec['bound_ms']!r} ({nbytes} B); library_ms null: no single "
            f"PyTorch call computes it ({card})")
    out.append(time_thermometer(torch, TC, mp, card, worst))
    for name, serve_rec in time_kv_forms(torch, TC, llm, card).items():
        recs[name]["serve"] = serve_rec
    return out


def time_thermometer(torch, TC, mp, card: str, worst: dict) -> dict:
    """Kernel 6 at the CIFAR input (batch 64, 32 x 32 x 3, m = 42): its
    image form as the main path calls it (f32 pixels in, quantizer fused),
    its levels form, and the former chain for the same work (the four
    eager passes of quantize_to_levels, then the levels form), each with
    caller-visible ms (CUDA events), device-only ms (torch.profiler; the
    chain's sums all its kernels) and wrapper host us; the bound of both
    forms (4-byte pixels or levels in, 42 bytes out each); then the image
    form's host split."""
    shape = (BATCH, CIFAR_HW, CIFAR_HW, 3)
    rng = np.random.default_rng(SEED + 2)
    img = torch.as_tensor(rng.random(shape), dtype=torch.float32,
                          device=DEVICE)
    levels = TC.quantize_to_levels(img, 2 * THERMO_M)
    nbytes = img.numel() * (4 + THERMO_M)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    forms = {
        "image": (lambda: TC.encode_image(img, THERMO_M),
                  lambda: TC.encode_image_plain(img, THERMO_M),
                  "thermo_kernel"),
        "levels": (lambda: TC.thermometer(levels, THERMO_M),
                   lambda: TC.thermometer_plain(levels, THERMO_M),
                   "thermo_kernel"),
        "chain": (lambda: TC.thermometer(
                      TC.quantize_to_levels(img, 2 * THERMO_M), THERMO_M),
                  None, ""),
    }
    got = {}
    for form, (kern, plain, part) in forms.items():
        ms = timed(torch, kern)
        dev, hus = device_ms(torch, kern, part), host_us(torch, kern)
        pms = None if plain is None else timed(torch, plain)
        got[form] = dict(ms=ms, device_ms=dev, host_us_per_call=hus,
                         plain_ms=pms)
        log(f"phase 5: thermometer {form} "
            + ("form " if plain is not None else "(the former chain: four "
               "eager passes + the levels form) ")
            + f"on {shape}: ms {ms!r} (device only {dev!r}; host us per "
            f"call {hus!r}) plain_ms {pms!r} bound_ms {bound!r} ({nbytes} "
            f"B); library_ms null: no single PyTorch call computes it "
            f"({card})")
    main = got["image"]
    rec = _record("thermometer", mp["launches"]["thermometer"],
                  worst["thermometer"], main["ms"], main["plain_ms"],
                  bound, 0.0, None)
    rec.update(shape=shape, form="encode_image", device_ms=main["device_ms"],
               host_us_per_call=main["host_us_per_call"],
               levels_form=dict(got["levels"], bound_ms=bound),
               chain=got["chain"])
    thermo_host_breakdown(torch, TC, img, card)
    return rec


def thermo_host_breakdown(torch, TC, img, card: str) -> None:
    """Where kernel 6's wrapper host microseconds go, for the image form
    at the CIFAR input: the whole wrapper, its output allocation alone,
    and the ctypes launch alone with its arguments made beforehand."""
    flat = img.reshape(-1)
    r = flat.numel()
    out = torch.empty((r, THERMO_M), dtype=torch.int8, device=img.device)
    fn = TC._library().cutie_thermometer
    args = (flat.data_ptr(), 1, out.data_ptr(), r, THERMO_M, 1,
            TC._stream(img.device))
    parts = {
        "wrapper": lambda: TC.encode_image(img, THERMO_M),
        "torch.empty of the output": lambda: torch.empty(
            (r, THERMO_M), dtype=torch.int8, device=img.device),
        "ctypes launch alone": lambda: fn(*args),
    }
    log(f"phase 5: encode_image host us per call at {tuple(img.shape)}: "
        + "; ".join(f"{what} {host_us(torch, f)!r}"
                    for what, f in parts.items())
        + f" (host clock, 50 calls, no synchronize; {card})")


def time_kv_forms(torch, TC, llm, card: str) -> dict:
    """Kernels 4 and 5 in their KV store forms at the trit serve's shapes:
    one decode step's K (or V) write, 512 bf16 rows of 64 (`ternarize_pack`),
    and its K (or V) gather, 131,072 rows of 13 bytes -> bf16 64
    (`unpack_dequant`), beside the bound, the plain version and the chain
    the store ran before the forms (the codec kernel proper inside eager
    torch ops, `_ChainCodec`), whose device time sums all its kernels."""
    rng = np.random.default_rng(SEED + 8)
    xw = kv_rows(rng, torch, KV_WRITE_ROWS, 64, "bfloat16")
    kb, ks = kv_packed(rng, torch, KV_ROWS, 13)
    chain = _ChainCodec(torch, TC)
    forms = {
        "pack_trits": (
            "ternarize_pack", (KV_WRITE_ROWS, 64),
            lambda: TC.ternarize_pack(xw),
            lambda: TC.ternarize_pack_plain(xw),
            lambda: chain.ternarize_pack(xw),
            xw.numel() * 2 + KV_WRITE_ROWS * (13 + 4),
            "ternarize_pack_kernel"),
        "unpack_trits": (
            "unpack_dequant", (KV_ROWS, 13),
            lambda: TC.unpack_dequant(kb, ks, 64),
            lambda: TC.unpack_dequant_plain(kb, ks, 64),
            lambda: chain.unpack_dequant(kb, ks, 64),
            kb.numel() + 4 * KV_ROWS + KV_ROWS * 64 * 2,
            "unpack_dequant_kernel"),
    }
    recs = {}
    for name, (form, shape, kern, plain, chained, nbytes, part) in \
            forms.items():
        ms, pms, cms = (timed(torch, kern), timed(torch, plain),
                        timed(torch, chained))
        dev, cdev = device_ms(torch, kern, part), device_ms(torch, chained, "")
        hus = host_us(torch, kern)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        recs[name] = dict(form=form, shape=shape, ms=ms, device_ms=dev,
                          host_us_per_call=hus, plain_ms=pms, chain_ms=cms,
                          chain_device_ms=cdev, bound_ms=bound,
                          bound_by="bytes",
                          launches=llm["trit"]["launches"][name])
        log(f"phase 5: {name} form {form} at the trit serve's {shape}: ms "
            f"{ms!r} (device only {dev!r}; host us per call {hus!r}) "
            f"plain_ms {pms!r}; the store's former chain (kernel proper + "
            f"torch ops) ms {cms!r} (device only, all its kernels, "
            f"{cdev!r}); bound_ms {bound!r} ({nbytes} B); launched "
            f"{recs[name]['launches']} times in phase 4's trit serve "
            f"({card})")
    codec_host_breakdown(torch, TC, kb, ks, card)
    return recs


def codec_host_breakdown(torch, TC, kb, ks, card: str) -> None:
    """Where the codec wrapper's host microseconds per call go, for the
    dequant form at the serve's shape: the whole wrapper, its output
    allocation alone, and the ctypes launch alone with its arguments made
    beforehand."""
    r, g = kb.shape
    out = torch.empty((r, 64), dtype=torch.bfloat16, device=kb.device)
    fn = TC._library().cutie_unpack_dequant
    args = (kb.data_ptr(), ks.data_ptr(), out.data_ptr(), r, g, 64,
            TC._stream(kb.device))
    parts = {
        "wrapper": lambda: TC.unpack_dequant(kb, ks, 64),
        "torch.empty of the output": lambda: torch.empty(
            (r, 64), dtype=torch.bfloat16, device=kb.device),
        "ctypes launch alone": lambda: fn(*args),
    }
    log(f"phase 5: unpack_dequant host us per call at ({r}, {g}) -> 64: "
        + "; ".join(f"{what} {host_us(torch, f)!r}"
                    for what, f in parts.items())
        + f" (host clock, 50 calls, no synchronize; {card})")


def trunk_timeline(torch, FT, x, ops_args, metas, stats: bool,
                   card: str, reps: int = 5) -> None:
    """Where one trunk launch's time goes, layer by layer, from the
    kernel's own %globaltimer stamps (`fused_trunk_timeline`; medians over
    ``reps`` launches): the span from the layer's first block start to its
    last block's end of tiles, the mean time a block spends on its tiles,
    the counters' pass (with ``stats``), the mean wait of a block at the
    grid barrier for the last one, and the barrier's release after the last
    arrival."""
    fn = lambda: FT.fused_trunk_timeline(  # noqa: E731
        x, *ops_args, metas=metas, emit_stats=stats)
    fn()
    runs = []
    for _ in range(reps):
        _, marks = fn()
        sync(torch)
        runs.append((marks.double() / 1e3).cpu().numpy())   # us
    m = np.median(np.stack(runs), axis=0)    # (L, grid, 3), per stamp
    t0 = m[:, :, 0].min(axis=1)              # the layer's first start
    busy = m[:, :, 1] - m[:, :, 0]
    parts = []
    for li in range(m.shape[0]):
        arrive = m[li, :, 2]
        release = (f"{t0[li + 1] - arrive.max():.2f}" if li + 1 < m.shape[0]
                   else "-")
        parts.append(
            f"layer {li}: span {m[li, :, 1].max() - t0[li]:.2f}, tiles "
            f"{busy[li].mean():.2f} per block (max {busy[li].max():.2f}), "
            f"counters {(m[li, :, 2] - m[li, :, 1]).mean():.2f}, barrier "
            f"wait {(arrive.max() - arrive).mean():.2f}, release {release}")
    total = m[-1, :, 2].max() - t0[0]
    log(f"phase 5: fused_trunk timeline ({'emit_stats' if stats else 'run'}"
        f", us, median of {reps} launches, stamps add 3 block barriers per "
        f"layer; first layer start to last arrival {total:.2f}; {card}): "
        + "; ".join(parts))


def host_us(torch, fn, reps: int = 50) -> float:
    """Host microseconds per call of ``fn`` until it returns, before a
    synchronize: the wrapper's own cost where the device keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / reps * 1e6


def trunk_host_breakdown(torch, FT, x, ops_args, metas, card: str) -> None:
    """Where kernel 3's host microseconds per call go, on the whole CIFAR
    trunk: the whole wrapper, its checks, plan lookup and allocations
    alone, and the ctypes launch alone with its arguments made
    beforehand.  The launch is the program's last host step on `fused`, so
    what comes before it adds to `run` one for one."""
    args, _outs, _held = FT._launch_args(x, *ops_args, metas=metas)
    fn = FT._library().cutie_fused_trunk
    parts = {
        "wrapper": lambda: FT.fused_trunk(x, *ops_args, metas=metas),
        "checks, plan lookup and allocations": lambda: FT._launch_args(
            x, *ops_args, metas=metas),
        "ctypes launch alone": lambda: fn(*args),
    }
    log("phase 5: fused_trunk host us per call on the CIFAR trunk: "
        + "; ".join(f"{what} {host_us(torch, f)!r}"
                    for what, f in parts.items())
        + f" (host clock, 50 calls, no synchronize; {card})")


def host_breakdown(torch, MM, x, wp, scale, card: str) -> None:
    """Where kernel 7's host microseconds per call go, at one decode
    projection: the whole wrapper, its output allocation alone, and the
    ctypes launch alone with its arguments made beforehand."""
    m, k = x.shape
    n = wp.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    sc = scale.to(torch.float32).contiguous()
    # held: the split-K scratch the arguments point into, alive until return
    args, held = MM._launch_args(x, wp, out, (sc, None, None, None),
                                 wp.shape[0], 1, "scale", True)
    fn = MM._kernel()
    parts = {
        "wrapper": lambda: MM.ternary_matmul(x, wp, scale=scale,
                                             round_scale=True),
        "torch.empty of the output": lambda: torch.empty(
            (m, n), dtype=x.dtype, device=x.device),
        "ctypes launch alone": lambda: fn(*args),
    }
    log(f"phase 5: ternary_matmul host us per call at ({m}, {k}) x ({k}, "
        f"{n}): " + "; ".join(f"{what} {host_us(torch, f)!r}"
                             for what, f in parts.items())
        + f" (host clock, 50 calls, no synchronize; {card})")


def time_matmul_kernels(torch, MM, llm, card: str, worst: dict
                        ) -> list[dict]:
    """Kernels 7 and 8 at each projection shape, at the decode M and the
    prefill bucket's M: ms per call (CUDA events), device-only ms of the
    kernel and of the library call (torch.profiler, every kernel of the
    call summed), the wrapper's host us per call, the bound and the plain
    version.  The JSON records sum one forward's 7 x n_layers projections:
    kernel 7 at the decode M (one decode step) with its prefill forward
    under "prefill", kernel 8 (no caller on the path) at the prefill M,
    where `torch._int_mm` applies."""
    from repro_torch.kernels import ref as R

    rng = np.random.default_rng(SEED + 7)
    n_layers = llm["cfg"].n_layers
    layer = llm["params"]["layers"][0]
    packed = {"q": layer["attn"]["wq"], "k": layer["attn"]["wk"],
              "v": layer["attn"]["wv"], "o": layer["attn"]["wo"],
              "gate": layer["mlp"]["gate"], "up": layer["mlp"]["up"],
              "down": layer["mlp"]["down"]}
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bytes_ms", "ops_ms", "host_us")
    tot = {(name, m): dict.fromkeys(keys, 0.0)
           for name in ("ternary_matmul", "ternary_matmul_dense")
           for m in (DECODE_M, PREFILL_M)}
    log(f"phase 5: matmul ms per call at the llama projection shapes on "
        f"{card} (CUDA events, mean of 20 after 3 warm-up calls, L2 warm; "
        "device-only ms from torch.profiler; host us until return)")
    for pname, k, n in LLM_PROJ:
        p = packed[pname]
        wp, scale = p["w_packed"], p["scale"]
        # the library yardstick's weights: trits * bf16(alpha), decoded once
        w_dec = (R.unpack_trits(wp.T).T[:k].to(torch.bfloat16)
                 * scale.to(torch.bfloat16))
        w8 = torch.as_tensor(rng.integers(-1, 2, (k, n)), dtype=torch.int8,
                             device=DEVICE)
        for m in (DECODE_M, PREFILL_M):
            x = torch.as_tensor(rng.standard_normal((m, k)),
                                dtype=torch.float32,
                                device=DEVICE).to(torch.bfloat16)
            if (pname, m) == ("q", DECODE_M):
                host_breakdown(torch, MM, x, wp, scale, card)
            x8 = torch.as_tensor(rng.integers(-1, 2, (m, k)),
                                 dtype=torch.int8, device=DEVICE)
            ops = 2 * m * k * n
            try:
                torch._int_mm(x8, w8)
                int_mm = (lambda: torch._int_mm(x8, w8))
            except RuntimeError:
                int_mm = None
            runs = {                       # kernel 7 as `linear` calls it
                "ternary_matmul": (
                    lambda: MM.ternary_matmul(x, wp, scale=scale,
                                              round_scale=True),
                    lambda: MM.ternary_matmul_plain(x, wp, scale=scale,
                                                    round_scale=True),
                    lambda: torch.matmul(x, w_dec),
                    wp.numel() + 2 * m * k + 2 * m * n + 4 * n,
                    ops / BF16_OPS_PER_S * 1e3, "torch.matmul bf16 x @ "
                    "pre-decoded bf16 trits*alpha"),
                "ternary_matmul_dense": (
                    lambda: MM.ternary_matmul_dense(x8, w8),
                    lambda: MM.ternary_matmul_dense_plain(x8, w8),
                    int_mm, k * n + m * k + 4 * m * n,
                    ops / INT8_OPS_PER_S * 1e3, "torch._int_mm"),
            }
            for name, (kern, plain, lib, nbytes, o_ms, lib_what) in \
                    runs.items():
                ms, pms = timed(torch, kern), timed(torch, plain)
                dev = device_ms(torch, kern, "ternary_mm")
                hus = host_us(torch, kern)
                lms = ldev = None
                if lib is not None:
                    lms = timed(torch, lib)
                    ldev = device_ms(torch, lib, "")
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ws_b = MM.workspace_bytes(m, k, n, torch.bfloat16
                                          if name == "ternary_matmul"
                                          else torch.int8)
                t = tot[(name, m)]
                for key, v in (("ms", ms), ("plain_ms", pms),
                               ("device_ms", dev), ("host_us", hus),
                               ("library_ms", lms),
                               ("library_device_ms", ldev),
                               ("bytes_ms", b_ms), ("ops_ms", o_ms)):
                    # a value not measured leaves the sum not measured
                    t[key] = None if v is None or t[key] is None else \
                        t[key] + n_layers * v
                log(f"  {name} {pname} ({m}, {k}) x ({k}, {n}): ms {ms!r} "
                    f"(device only {dev!r}; host us per call {hus!r}) "
                    f"plain_ms {pms!r} library_ms {lms!r} (device only "
                    f"{ldev!r}; {lib_what}"
                    f"{'' if lms is not None else ': shape not accepted'}) "
                    f"bound_ms {max(b_ms, o_ms)!r} "
                    f"({'bytes' if b_ms > o_ms else 'operations'}: {nbytes} "
                    f"B, {ops} ops); split-K workspace {ws_b} B written and "
                    "read back per call, outside the bound")
    recs = {}
    for (name, m), t in tot.items():
        calls = 7 * n_layers
        per = f"one forward's {calls} projections at M = {m}"
        host = None if t["host_us"] is None else t["host_us"] / calls
        log(f"phase 5: {name} summed over {per}: ms {t['ms']!r} (device "
            f"only {t['device_ms']!r}; wrapper host us per call {host!r}) "
            f"plain_ms {t['plain_ms']!r} library_ms {t['library_ms']!r} "
            f"(device only {t['library_device_ms']!r}) bound_ms "
            f"{max(t['bytes_ms'], t['ops_ms'])!r} ({card})")
        launches = llm["launches"] if name == "ternary_matmul" else 0
        rec = _record(name, launches, worst[name], t["ms"], t["plain_ms"],
                      t["bytes_ms"], t["ops_ms"], t["library_ms"])
        rec.update(m=m, device_ms=t["device_ms"],
                   library_device_ms=t["library_device_ms"],
                   host_us_per_call=host)
        recs[(name, m)] = rec
    # kernel 7: one decode step, with one prefill forward beside it
    k7 = recs[("ternary_matmul", DECODE_M)]
    k7["prefill"] = {key: v for key, v in
                     recs[("ternary_matmul", PREFILL_M)].items()
                     if key in ("m", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "library_device_ms", "host_us_per_call")}
    return [k7, recs[("ternary_matmul_dense", PREFILL_M)]]


def _serving_line(label: str, run: dict, card: str) -> None:
    st = run["stats"]
    toks = sum(len(t) for t in run["tokens"])
    dec = run["spans"]["decode"]
    pre = run["spans"]["prefill"]
    lat = st["latency"]
    log(f"phase 5: serving {label}: {LLM_REQUESTS} requests, {toks} tokens "
        f"in {run['seconds']!r} s ({toks / run['seconds']!r} tokens/s); "
        f"decode step ms median {float(np.median(dec))!r} (min {min(dec)!r}, "
        f"{len(dec)} steps); prefill ms median {float(np.median(pre))!r} "
        f"(first {pre[0]!r}, {len(pre)} prefills); latency p50 "
        f"{lat['p50']!r} s p99 {lat['p99']!r} s (host clock, {card})")


def serving_profile(torch, S, params, cfg, prompts, card: str,
                    label: str = "ternary_packed paged") -> None:
    """One more run under torch.profiler (CUDA activity): the device's
    busy share of the run's host-clock time, and the kernels that take
    the device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = serve(torch, S, params, cfg, prompts)
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    log(f"phase 5: serving {label} under torch.profiler: "
        f"{run['seconds']!r} s host clock, device busy {busy!r} s "
        f"({busy / run['seconds']!r} of it; idle share "
        f"{1 - busy / run['seconds']!r}); {card}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3!r} ms in {e.count} "
            f"calls: {e.key[:90]}")


def serving_numbers(torch, S, TF, llm, card: str) -> None:
    """The main path's serving times, a second ternary_packed run (warm),
    and the same requests on quant="none", the bf16 baseline the
    reference's examples/serve_ternary.py also serves."""
    cfg, params, prompts = llm["cfg"], llm["params"], llm["prompts"]
    _serving_line("ternary_packed paged (first run)", llm["paged"], card)
    _serving_line("ternary_packed contiguous", llm["contiguous"], card)
    warm = serve(torch, S, params, cfg, prompts)
    _serving_line("ternary_packed paged (second run)", warm, card)
    serving_profile(torch, S, params, cfg, prompts, card)
    base_cfg = cfg.replace(quant="none")
    base_params = llm_params(torch, TF, base_cfg)
    for i in range(2):
        base = serve(torch, S, base_params, base_cfg, prompts)
        _serving_line(f"bf16 baseline quant='none' paged (run {i + 1})",
                      base, card)
    del base_params
    torch.cuda.empty_cache()


def trit_serving_numbers(torch, S, TC, codec, llm, card: str) -> None:
    """The trit serve with the codec's KV forms (``fused``) against the
    same serve with the store's former chain (`_ChainCodec`, ``chain``):
    decode-step medians from a serve of each in turns (chain, fused,
    fused, chain), then the device's busy seconds of one serve of each
    under torch.profiler.  Both must give the phase-4 trit tokens."""
    from torch.profiler import ProfilerActivity, profile

    cfg, params, prompts = llm["cfg"], llm["params"], llm["prompts"]
    codecs = {"chain": _ChainCodec(torch, TC), "fused": None}

    def run(label, profiled=False):
        saved = codec._tc
        if codecs[label] is not None:
            codec._tc = codecs[label]
        try:
            if not profiled:
                return serve(torch, S, params, cfg, prompts,
                             kv_codec="trit"), None
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                got = serve(torch, S, params, cfg, prompts, kv_codec="trit")
            return got, sum(e.self_device_time_total
                            for e in prof.key_averages()) / 1e6
        finally:
            codec._tc = saved

    for label in ("chain", "fused", "fused", "chain"):
        got, _ = run(label)
        if got["tokens"] != llm["trit"]["tokens"]:
            raise RuntimeError(f"llm trit ({label}): tokens differ from "
                               "phase 4's trit serve")
        _serving_line(f"ternary_packed paged kv_codec='trit' ({label})",
                      got, card)
    for label in ("chain", "fused"):
        got, busy = run(label, profiled=True)
        dec = got["spans"]["decode"]
        log(f"phase 5: trit serve ({label}) under torch.profiler: "
            f"{got['seconds']!r} s host clock, device busy {busy!r} s "
            f"(idle share {1 - busy / got['seconds']!r}); decode step ms "
            f"median {float(np.median(dec))!r}; {card}")



def _median_ms(torch, fn, reps: int = 10, warm: int = 3) -> tuple:
    """Median and min host-clock ms of ``fn`` ending in a synchronize."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), min(ts)


def cnn_numbers(torch, Q, CNN, S, P, adam, cifar, cnn, card: str) -> None:
    """The train -> compile -> serve path's times: one QAT step at full
    width (host clock ending in a synchronize) and its forward + backward
    share, one evaluation batch, the serves' throughput and latencies per
    scheduler and tag, one engine step per bucket and model, and the
    device's busy share of a closed-loop serve under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    result, compiled, pool = cnn["result"], cnn["compiled"], cnn["pool"]
    model, rc = result["model"], result["run_config"]
    acfg = Q.adam_config(rc)
    batch = cifar.encoded_batch(rc.data, "train", 0, rc.batch,
                                device=DEVICE)
    state = {"opt": adam.init_state(model.trainable())}

    def step():
        state["opt"], _ = Q.train_step(model, state["opt"], batch, acfg)

    def fwd_bwd():
        loss, _ = CNN.loss_fn(model, batch, train=True, inq=True)
        torch.autograd.grad(loss, list(model.trainable().values()))

    ev = cifar.encoded_batch(rc.data, "test", 0, 128, device=DEVICE)["x"]

    def evaluate():
        with torch.no_grad():
            model(ev, train=False, inq=True)

    for _ in range(2):                      # in turns: step, fwd+bwd
        st, st_min = _median_ms(torch, step)
        fb, fb_min = _median_ms(torch, fwd_bwd)
        log(f"phase 5: QAT step at width {model.cfg.width}, batch "
            f"{rc.batch} (float64 pre-activations): median ms {st!r} (min "
            f"{st_min!r}); forward + backward median {fb!r} (min {fb_min!r})"
            f", optimizer + BN update the rest, {st - fb!r}; host clock, "
            f"{card}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"phase 5: 5 QAT steps under torch.profiler: {wall!r} s host "
        f"clock, device busy {busy!r} s (busy share {busy / wall!r}); "
        f"{card}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  device {e.self_device_time_total / 1e3!r} ms in {e.count} "
            f"calls: {e.key[:90]}")
    ms, ms_min = _median_ms(torch, evaluate)
    log(f"phase 5: QAT evaluation batch of 128 (inference BN, INQ "
        f"weights): median ms {ms!r} (min {ms_min!r}); host clock, {card}")
    served = cnn["served"]
    for sched in ("fcfs", "deadline"):
        s, wall = served[sched]["stats"], served[sched]["wall"]
        tags = {t: (v["n"], v["p50"], v["p99"], v["deadline_met_frac"])
                for t, v in s["by_tag"].items()}
        log(f"phase 5: CNN serve under {sched}: {s['n_done']} images in "
            f"{wall!r} s ({s['n_done'] / wall!r} images/s) at "
            f"{served['rate']!r} req/s offered; latency s p50 "
            f"{s['latency']['p50']!r} p99 {s['latency']['p99']!r}; by tag "
            f"(n, p50, p99, deadline met) {tags}; interactive target "
            f"{served['target']!r} s; batch occupancy "
            f"{s['batch_occupancy']!r}; host clock, {card}")
    ex = S.ProgramExecutor(compiled.pipeline("ref", device=DEVICE))
    t0 = time.perf_counter()
    for img in pool["imgs"]:
        ex.validate(img)
    us = (time.perf_counter() - t0) / len(pool["imgs"]) * 1e6
    log(f"phase 5: ProgramExecutor.validate at submit (the reference's "
        f"trit-domain check, host numpy): {us!r} us per {pool['imgs'][0].shape}"
        f" image; {card}")
    for model_name in ("cnn-cuda", "cnn-fused"):
        eng = S.CutieEngine("fcfs")
        backend = model_name.split("-")[1]
        eng.register(model_name, compiled, backend=backend, device=DEVICE,
                     buckets=SERVE_BUCKETS)
        per = {}
        for b in SERVE_BUCKETS:
            ts = []
            for rep in range(6):
                for i in range(b):
                    eng.submit(pool["imgs"][i], model=model_name)
                t0 = time.perf_counter()
                eng.step()
                if rep:                     # the first builds the variant
                    ts.append((time.perf_counter() - t0) * 1e3)
            per[b] = float(np.median(ts))
        log(f"phase 5: one engine step per bucket on {model_name} (ms, "
            f"median of 5, host clock, response on the host): {per}; "
            f"{card}")
    eng = _serve_engine(S, P, compiled, "fcfs")
    for i in range(16):                     # warm every variant
        eng.submit(pool["imgs"][i], model=("cnn-cuda", "cnn-fused")[i % 2])
    eng.run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(SERVE_POOL):
            eng.submit(pool["imgs"][i], model=("cnn-cuda", "cnn-fused")[i % 2])
        eng.run()
        wall = time.perf_counter() - t0
    evs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"phase 5: closed-loop CNN serve of {SERVE_POOL} images under "
        f"torch.profiler: {wall!r} s host clock, device busy {busy!r} s "
        f"(busy share {busy / wall!r}, idle share {1 - busy / wall!r}); "
        f"{card}")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  device {e.self_device_time_total / 1e3!r} ms in {e.count} "
            f"calls: {e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        # synthcifar seeds its samples with hash(split): run under a fixed
        # salt so the QAT run's data, loss and accuracy repeat across runs
        return subprocess.run(
            [sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
            env={**os.environ, "PYTHONHASHSEED": HASH_SEED}).returncode
    import torch.nn.functional as F

    from repro_torch import compiler, configs
    from repro_torch import pipeline as P
    from repro_torch import serving as S
    from repro_torch.configs import cutie_cnn as configs_cnn
    from repro_torch.core import codec, engine, inq, thermometer
    from repro_torch.core import ternary as T
    from repro_torch.data import cifar
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_trunk as FT
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_conv2d as K
    from repro_torch.kernels import ternary_matmul as MM
    from repro_torch.kernels import trit_codec as TC
    from repro_torch.models import common as C
    from repro_torch.models import cutie_cnn as CNN
    from repro_torch.models import decoding as DEC
    from repro_torch.models import moe
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adam
    from repro_torch.train import cutie_qat as Q
    from repro_torch.train import loop

    t0 = time.perf_counter()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    names = _build.build_all()
    for n in names:
        for line in _build.BUILD_LOGS.get(n, "").splitlines():
            if any(key in line for key in ("registers", "spill",
                                           "entry function")):
                log(f"  ptxas {n}: {line.strip()}")
    log(f"phase 2: built {names} in {time.perf_counter() - t0:.1f} s")
    for li, c in enumerate(conv_cases()[:len(CIFAR_POOLS)]):
        plan = K.conv_plan(c["n"], c["h"], c["w"], c["cin"], c["cout"], 3,
                           (1, 1), True, c["pool"])
        per_sm = K.blocks_per_sm(plan["smem"], plan["groups"])
        log(f"  CIFAR layer {li} conv plan: tile {plan['th']}x{plan['tw']}, "
            f"Cout slice {plan['ns']}, {plan['groups']} pipelines per "
            f"block, grid {plan['slices'] * plan['gpb']}, {plan['smem']} B "
            f"of dynamic shared memory, {per_sm} blocks per SM")
    log_trunk_plan(FT, trunk_cases()[0])

    spent = [("start", time.perf_counter())]   # seconds per path
    worst = compare_kernels(torch, K, codec)
    compare_new_kernels(torch, FT, TC, worst)
    compare_matmul_kernels(torch, MM, worst)
    spent.append(("compare", time.perf_counter()))
    mp = main_path(torch, K, FT, TC, ops, engine, thermometer, compiler, P)
    spent.append(("main_path", time.perf_counter()))
    compiled_programs(torch, K, FT, P, compiler)
    spent.append(("compiled_programs", time.perf_counter()))
    mesh = mesh_path(torch, P, engine, mp, card)
    _add_counts(mp["launches"], mesh["launches"])
    spent.append(("mesh_path", time.perf_counter()))
    llm = llm_main_path(torch, MM, TC, S, TF, DEC, C, codec, configs)
    spent.append(("llm_main_path", time.perf_counter()))
    restart_path(torch, TC, S, llm)
    spent.append(("restart_path", time.perf_counter()))
    spec_path(torch, MM, TC, S, TF, DEC, codec, llm, card)
    spent.append(("spec_path", time.perf_counter()))
    llm_train_path(torch, TF, inq, loop, card)
    spent.append(("llm_train_path", time.perf_counter()))
    llm["launches"] += model_mesh_path(torch, MM, TF, DEC, llm, card)
    spent.append(("model_mesh_path", time.perf_counter()))
    llm["launches"] += gpipe_tp_path(torch, MM, TF, DEC, C, configs, llm,
                                     card)
    spent.append(("gpipe_tp_path", time.perf_counter()))
    torch.cuda.empty_cache()
    moe_run = moe_path(torch, MM, TC, S, TF, DEC, C, codec, moe, configs,
                       card)
    spent.append(("moe_path", time.perf_counter()))
    torch.cuda.empty_cache()
    ssm_run = ssm_path(torch, MM, TC, S, TF, DEC, C, codec, configs, card)
    spent.append(("ssm_path", time.perf_counter()))
    torch.cuda.empty_cache()
    runs = [moe_run, ssm_run]
    for path in (hybrid_path, encdec_path):
        runs.append(path(torch, MM, TF, DEC, C, configs, card))
        spent.append((path.__name__, time.perf_counter()))
        torch.cuda.empty_cache()
    runs.append(vlm_path(torch, MM, TC, S, TF, DEC, C, configs, card))
    spent.append(("vlm_path", time.perf_counter()))
    torch.cuda.empty_cache()
    llm["launches"] += sum(r["launches"] for r in runs)
    _add_counts(mp["launches"], moe_run["codec"])
    _add_counts(mp["launches"], ssm_run["codec"])
    cnn = cnn_main_path(torch, K, FT, TC, P, S, Q, CNN, inq, adam, cifar,
                        configs_cnn, engine, compiler, ops)
    spent.append(("cnn_main_path", time.perf_counter()))
    program_latency(torch, P, mp, card)
    spent.append(("program_latency", time.perf_counter()))
    kernels, conv_lib = time_kernels(torch, F, K, codec, engine, mp, card,
                                        worst)
    kernels += time_new_kernels(torch, FT, TC, mp, llm, card, worst,
                                conv_lib)
    kernels += time_matmul_kernels(torch, MM, llm, card, worst)
    spent.append(("time_kernels", time.perf_counter()))
    # kernel 7 at the large M of the encdec and vlm paths, one encode or
    # one forward's projections (phase 4's k7_times)
    k7 = next(r for r in kernels if r["name"] == "ternary_matmul")
    k7["large_m"] = {str(r["m"]): {
        "ms": r["times"]["ms"], "device_ms": r["times"]["device_ms"],
        "plain_ms": r["times"]["plain_ms"],
        "library_ms": r["times"]["library_ms"],
        "library_device_ms": r["times"]["library_device_ms"],
        "bound_ms": max(r["times"]["bytes_ms"], r["times"]["ops_ms"])}
        for r in runs if "times" in r}
    serving_numbers(torch, S, TF, llm, card)
    spent.append(("serving_numbers", time.perf_counter()))
    trit_serving_numbers(torch, S, TC, codec, llm, card)
    spent.append(("trit_serving_numbers", time.perf_counter()))
    cnn_numbers(torch, Q, CNN, S, P, adam, cifar, cnn, card)
    spent.append(("cnn_numbers", time.perf_counter()))
    reset_launches(K, FT, TC, MM)          # timing launches are not counted
    log("seconds per path: " + ", ".join(
        f"{name} {t - prev:.1f}" for (_, prev), (name, t) in
        zip(spent, spent[1:])))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--restore"]:
        sys.exit(restore_main(sys.argv[2]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--model-mesh-rank"]:
        sys.exit(model_mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                      sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--gpipe-tp-rank"]:
        sys.exit(gpipe_tp_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                    sys.argv[4], sys.argv[5]))
    sys.exit(main())
