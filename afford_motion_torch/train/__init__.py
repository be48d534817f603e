"""Sampling chain and checkpoints."""
