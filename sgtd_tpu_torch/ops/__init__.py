"""Kernels (B1-B3, each beside its plain PyTorch version) and small linear
algebra."""
