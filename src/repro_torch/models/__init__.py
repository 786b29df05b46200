"""Models: the QAT CNN of the paper (`cutie_cnn`) and the LLM stack,
dense family: shared layers, attention, MLP, the model assembly and the
serving-time prefill and decode paths."""
