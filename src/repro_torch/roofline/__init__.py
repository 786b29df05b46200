"""Parameter counts and roofline terms for model-FLOP accounting."""
