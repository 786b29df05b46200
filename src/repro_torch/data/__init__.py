"""Data: synthcifar (the CNN's dataset) and a background prefetcher."""
