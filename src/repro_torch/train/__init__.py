"""Training: QAT of the CUTIE CNN on synthcifar."""
