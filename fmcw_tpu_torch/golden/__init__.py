"""Numpy pieces of the golden models that the port needs (copies)."""
