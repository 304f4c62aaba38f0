"""Checkpoints (``.pth`` and the JAX package's ``.msgpack``), metrics,
FLOP counts, logging and file access of the port."""
