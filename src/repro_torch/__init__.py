"""CUTIE on PyTorch and hand-written Hopper kernels.

The second package beside `repro` (JAX/Pallas, the reference): the same
module tree, plain functions on tensors, and CUDA C++ kernels under
`csrc/` where the reference has Pallas.  Two paths run: the ternary CNN
(`repro_torch.pipeline.CutiePipeline`) and ternary-packed LLM serving
(`repro_torch.serving.CutieEngine` + `LLMExecutor`, dense family).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise
(`repro_torch.device.resolve_device`).
"""
