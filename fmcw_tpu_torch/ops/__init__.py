"""Signal-processing ops: plain PyTorch functions and the kernel wrappers."""
