"""Hand-written Hopper kernels for CUTIE and their plain PyTorch twins."""
