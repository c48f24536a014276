"""Utilities: golden-file I/O, log formats, checkpoints."""
