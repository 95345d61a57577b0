"""Hand-written Hopper kernels, their plain PyTorch versions, and the
kernel-variant registry (``ops``)."""
