"""Models: the QAT CNN of the paper (`cutie_cnn`) and the LLM stack,
dense, moe and ssm families: shared layers, attention, MLP, the MoE
layer, the mamba2 mixer, the model assembly and the serving-time
prefill and decode paths."""
