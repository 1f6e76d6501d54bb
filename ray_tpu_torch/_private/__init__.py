"""Internals of the PyTorch port: device resolution and serving knobs."""
