"""Serving (PyTorch port, plain path): the slot decode engine, the
continuous-batching scheduler core, and its metrics."""
