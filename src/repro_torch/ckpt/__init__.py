"""Atomic, async-capable checkpoints of tensor trees."""
