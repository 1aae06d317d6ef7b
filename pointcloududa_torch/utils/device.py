"""Where the port's entry points run: on the card, unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device, and raises when there is none
    (nothing carries on on the CPU by itself); anything else is taken as the
    caller's explicit choice, e.g. ``"cpu"`` in the CPU tests."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pointcloududa_torch runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
