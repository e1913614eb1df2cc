"""Hand-written Hopper kernels of the port, their plain PyTorch versions and
their build (``_build``). Nothing is built or loaded at import time."""
