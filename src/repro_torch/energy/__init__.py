"""Switching activity and the calibrated CUTIE energy model."""
