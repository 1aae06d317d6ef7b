"""The generator architectures, one file each, found by the configuration's
``arch`` (``perfbench/reference/arch/<arch>.py``): a later configuration
brings a new architecture as a new file here, and nothing else changes.

An architecture's module exposes

- ``build_generator(cfg, generator, compute_dtype)``: the generator, an
  ``nn.Module`` whose ``forward(x_nhwc, generator)`` returns
  ``(logits_nhwc, None, points)`` (float32 NHWC logits, the (B, 300, 3)
  cloud where ``cfg.point_head``, else ``None``), its initial weights drawn
  from the CPU ``generator`` (``None`` on the meta device), every product
  routed through ``numerics`` (its ``Conv2d``, ``Conv1d``, ``Linear`` and
  ``Product``) and every BatchNorm's statistics through
  ``numerics.batch_stats``, so that the control and the float64 witness
  reach it;
- ``generator_flops(count, cfg, b, train)``: the model FLOPs of one forward
  on a batch of ``b``, added to ``count`` (``counting.Count``) product by
  product; ``train``: the pass trains the generator's weights;
- optionally ``INIT_RULES``: ``[(module type, rule)]`` for the module kinds it
  brings, tried before ``weights.BASE_RULES`` (``weights.py`` says what a
  rule is).
"""

from __future__ import annotations

import importlib.util
import os

DIR = os.path.dirname(os.path.abspath(__file__))
_loaded: dict = {}


class UnknownArch(ValueError):
    pass


def of(cfg) -> str:
    """The configuration's architecture: the U-Net where it names none (the
    port's ``UDAConfig`` has no ``arch`` until a second architecture comes)."""
    return getattr(cfg, "arch", "unet")


def path(name: str) -> str:
    return os.path.join(DIR, f"{name}.py")


def check(name: str) -> None:
    """Raise ``UnknownArch``, naming the missing file, where ``name`` has none."""
    if not os.path.isfile(path(name)):
        raise UnknownArch(f"architecture {name!r}: no file {path(name)}")


def load(name: str):
    """The module of the architecture ``name``."""
    check(name)
    file = path(name)
    if file not in _loaded:
        spec = importlib.util.spec_from_file_location(f"perfbench_arch_{name.replace('-', '_')}", file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[file] = module
    return _loaded[file]
