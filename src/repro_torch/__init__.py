"""CUTIE on PyTorch and hand-written Hopper kernels.

The second package beside `repro` (JAX/Pallas, the reference): the same
module tree, plain functions on tensors, and CUDA C++ kernels under
`csrc/` where the reference has Pallas.  The ternary CNN trains
(`repro_torch.train.cutie_qat`), compiles (`repro_torch.compiler`), runs
(`repro_torch.pipeline.CutiePipeline`) and serves
(`repro_torch.serving.CutieEngine` + `ProgramExecutor`); ternary-packed
LLMs serve through the same engine with `LLMExecutor` (dense, moe and
ssm families).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise
(`repro_torch.device.resolve_device`).
"""
