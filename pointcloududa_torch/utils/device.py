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


def describe(device) -> str:
    """What a run's numbers were taken on: for a CUDA device its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card may be set below its maximum
    power and then runs slower), for any other device its type."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    import subprocess

    index = torch.cuda.current_device() if device.index is None else device.index
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(index)}, power limit not read"
