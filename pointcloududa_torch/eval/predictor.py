"""Serving-oriented inference: a predictor with its weights fixed, and a
portable ``torch.export`` artifact (counterpart of the JAX package's
``eval/predictor.py``, whose artifact is StableHLO).

The reference has no serving story (inference = re-running the eval script
with a checkpoint). For deployment this module provides:

- :class:`Predictor` — weights copied in at construction, the generator in
  eval mode, a fixed batch with tail padding;
- :func:`export_predictor` / :func:`load_exported` — ``torch.export``
  serialisation: the artifact embeds the weights and runs without the
  package's model code.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from pointcloududa_torch.config import UDAConfig
from pointcloududa_torch.train.state import build_generator
from pointcloududa_torch.utils.device import resolve_device


def _frozen_generator(cfg: UDAConfig, net: torch.nn.Module, device) -> torch.nn.Module:
    """A fresh generator built from ``cfg`` holding a copy of ``net``'s
    weights, in eval mode on ``device``, with no gradients."""
    gen = build_generator(cfg)
    gen.load_state_dict(net.state_dict())
    gen.eval().requires_grad_(False)
    return gen.to(device)


class Predictor:
    """Segmentation forward with the weights of ``net`` (a generator module)
    as they were at construction. Returns logits (and the point cloud when
    the config has the point head). ``device=None`` is the card, and raises
    without one."""

    def __init__(self, cfg: UDAConfig, net: torch.nn.Module, batch_size: int = 8, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self._gen = _frozen_generator(cfg, net, self.device)

    def __call__(self, images: np.ndarray):
        """images: (N, H, W, C) float32 — any N; internally padded to the
        batch size. Returns numpy (logits, points or None)."""
        n = len(images)
        bs = self.batch_size
        logits_out, points_out = [], []
        with torch.inference_mode():
            for i in range(0, n, bs):
                chunk = np.asarray(images[i : i + bs], np.float32)
                pad = bs - len(chunk)
                if pad:
                    chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
                logits, _, points = self._gen(torch.from_numpy(chunk).to(self.device))
                keep = bs - pad
                logits_out.append(logits[:keep].cpu().numpy())
                if self.cfg.point_head:
                    points_out.append(points[:keep].cpu().numpy())
        logits = np.concatenate(logits_out)
        points = np.concatenate(points_out) if points_out else None
        return logits, points


class _Forward(torch.nn.Module):
    """What the artifact computes: logits, or (logits, points) with the
    point head."""

    def __init__(self, gen: torch.nn.Module, point_head: bool):
        super().__init__()
        self.gen = gen
        self.point_head = point_head

    def forward(self, x: torch.Tensor):
        logits, _, points = self.gen(x)
        return (logits, points) if self.point_head else logits


def export_predictor(cfg: UDAConfig, net: torch.nn.Module, batch_size: int = 8, device=None) -> bytes:
    """Serialise the eval-mode forward at (batch_size, crop, crop,
    in_channels) float32, weights embedded, with ``torch.export.save``.
    The program is traced on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    fwd = _Forward(_frozen_generator(cfg, net, device), cfg.point_head).eval()
    example = torch.zeros(batch_size, cfg.crop_size, cfg.crop_size, cfg.in_channels, device=device)
    program = torch.export.export(fwd, (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_exported(blob: bytes, device=None):
    """Returns a callable(images) over the artifact's program on ``device``
    (``None``: the card); it takes a numpy array or a tensor and returns the
    program's tensors on that device."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    program = move_to_device_pass(torch.export.load(io.BytesIO(blob)), device)
    module = program.module()

    def run(images):
        with torch.inference_mode():
            return module(torch.as_tensor(images, dtype=torch.float32, device=device))

    return run
