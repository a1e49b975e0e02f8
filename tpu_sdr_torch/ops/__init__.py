"""DSP operators of the port: plain PyTorch ops and the kernel wrappers."""
