"""Optimizers: AdamW as a functional update, ternary gradient compression."""
