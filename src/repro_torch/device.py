"""The port's device rule, shared by ``core``, ``models`` and ``serving``:
entry points run on the card unless the caller asks for the CPU, and asking
for CUDA where there is none raises; nothing falls back to the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``torch.device`` for a run; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} was asked for but torch sees no CUDA device; "
                           "pass device='cpu' to run the plain version on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
