"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Turn ``device`` into a ``torch.device``; raise if it names a CUDA
    device and none is present.  Nothing falls back to the CPU on its own:
    a caller that wants the CPU passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
