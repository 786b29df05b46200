"""Data: synthcifar (the CNN's dataset), synthetic LM tokens and a
background prefetcher."""
