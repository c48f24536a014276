"""Utilities: golden-file I/O, log formats, checkpoints, the Pd/Pfa
harness and the analysis layer (log parsing, plots, velocity unfolding)."""
