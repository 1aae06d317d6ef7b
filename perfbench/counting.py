"""The benchmark's own arithmetic: the chip's published peaks, the model
FLOPs of one training step from the configuration's shapes, and the bytes
and operations of the BatchNorm-statistics and FPS kernels.

Step FLOPs: the generator's from its architecture's ``generator_flops``
(``reference/arch/<arch>.py``), the discriminators' here; forward and backward of every convolution, linear layer and
matrix product in phases 1-5 of ``train/step.py``, counted as
``torch.utils.flop_counter.FlopCounterMode`` counts them (2 per
multiply-add; a backward counts a product for each gradient autograd
computes: the input's where the input needs one, the weight's where the
pass trains it). Nothing recomputed is counted; BatchNorm, activations,
pooling, losses and the Chamfer loss have no products and count 0.
``perfbench/tests/test_counting.py`` holds the count equal to
``FlopCounterMode`` on the port's step.
"""

from __future__ import annotations

from dataclasses import dataclass

from perfbench.reference import arch

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


@dataclass
class Count:
    """The running count of one step's FLOPs, which each network's count
    adds to product by product (an architecture's ``generator_flops`` too)."""

    flops: float = 0.0

    def product(self, fwd: float, x_grad: bool, w_grad: bool) -> bool:
        """Add a product's forward and the backward products autograd runs;
        returns whether its output needs a gradient."""
        self.flops += fwd * (1 + int(x_grad) + int(w_grad))
        return x_grad or w_grad

    def conv(self, b, cin, cout, k, h_out, w_out, x_grad, w_grad) -> bool:
        """A k x k convolution from ``cin`` to ``cout`` channels with a
        (b, cout, h_out, w_out) output."""
        return self.product(2.0 * b * cout * h_out * w_out * cin * k * k, x_grad, w_grad)


def _out(h: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def image_disc_flops(c: Count, cfg, b: int, ext: bool, x_grad: bool, train: bool) -> None:
    """One forward of an output or entropy discriminator on (b, S, S, n_class)."""
    s = cfg.crop_size
    layers = [(cfg.n_class, 64, 4, 2, 2), (64, 128, 4, 2, 2), (128, 256, 4, 2, 2), (256, 512, 4, 2, 2)]
    if ext:
        layers += [(512, 1024, 3, 2, 1), (1024, 256, 3, 2, 1)]
    layers.append((256 if ext else 512, 1, 4, 2, 2))
    for cin, cout, k, st, p in layers:
        s = _out(s, k, st, p)
        x_grad = c.conv(b, cin, cout, k, s, s, x_grad, train)


def _stn_flops(c: Count, b: int, n: int, k: int, x_grad: bool, train: bool) -> bool:
    g = x_grad
    for cin, cout in ((k, 64), (64, 128), (128, 1024)):
        g = c.conv(b, cin, cout, 1, n, 1, g, train)
    for cin, cout in ((1024, 512), (512, 256), (256, k * k)):
        g = c.product(2.0 * b * cin * cout, g, train)
    # x (B, N, k) @ trans (B, k, k): the points' gradient where they need one,
    # the transform's where the STN trains or the points need one
    return c.product(2.0 * b * n * k * k, x_grad, g)


def point_disc_flops(c: Count, cfg, b: int, x_grad: bool, train: bool, n: int = 300) -> None:
    """One forward of the PointNet discriminator D4 on (b, n, 3) clouds."""
    g = _stn_flops(c, b, n, 3, x_grad, train)
    ladder = ((3, 8), (8, 64)) if cfg.extd4 else ((3, 64),)
    for cin, cout in ladder:
        g = c.conv(b, cin, cout, 1, n, 1, g, train)
    if cfg.ft:
        g = _stn_flops(c, b, n, 64, g, train)
    ladder = ((64, 128), (128, 256), (256, 512), (512, 1024)) if cfg.extd4 else ((64, 128), (128, 1024))
    for cin, cout in ladder:
        g = c.conv(b, cin, cout, 1, n, 1, g, train)
    for cin, cout in ((1024, 512), (512, 256), (256, 1)):
        g = c.product(2.0 * b * cin * cout, g, train)


def step_flops(cfg) -> float:
    """Model FLOPs of one call of the 5-phase step at ``cfg.bs``."""
    c, b = Count(), cfg.bs
    generator_flops = arch.load(arch.of(cfg)).generator_flops
    # phases 1+2: the generator on source and target; the adversaries on the
    # target outputs pass the gradient back to the generator but train nothing
    generator_flops(c, cfg, b, train=True)
    generator_flops(c, cfg, b, train=True)
    if cfg.d2:
        image_disc_flops(c, cfg, b, cfg.extd2, x_grad=True, train=False)
    if cfg.d4:
        point_disc_flops(c, cfg, b, x_grad=True, train=False)
    if cfg.d1:
        image_disc_flops(c, cfg, b, cfg.extd1, x_grad=True, train=False)
    # phases 3-5: each adversary on the detached source and target outputs
    for _ in range(2):
        if cfg.d1:
            image_disc_flops(c, cfg, b, cfg.extd1, x_grad=False, train=True)
        if cfg.d2:
            image_disc_flops(c, cfg, b, cfg.extd2, x_grad=False, train=True)
        if cfg.d4:
            point_disc_flops(c, cfg, b, x_grad=False, train=True)
    return c.flops


def bn_stats_work(shape, dtype_bytes: int, backward: bool) -> tuple:
    """(bytes, operations) of one BN-statistics launch over an (N, C, H, W)
    input: the forward reads x once and writes the (2, C) f32 statistics,
    3 operations an element (x, and x * x into two sums); the backward reads
    x and writes dx once, 2 operations an element (one fused multiply-add).
    Its (2, C) gradient input is negligible and counted."""
    n, c = shape[0], shape[1]
    elems = n * c
    for d in shape[2:]:
        elems *= d
    if backward:
        return 2.0 * elems * dtype_bytes + 2 * c * 4, 2.0 * elems
    return elems * dtype_bytes + 2 * c * 4, 3.0 * elems


def fps_work(b: int, p: int, k: int, valid_total: float) -> tuple:
    """(bytes, operations) of one FPS launch: the (B, P) validity bytes, the
    (P, 3) f32 grid (broadcast over the batch, read once), the (B,) starts
    read once and the (B, k, 3) f32 clouds written once; over k - 1 rounds
    every valid candidate's distance update and argmax: 3 differences,
    3 products and 2 sums, a minimum and a comparison, 10 operations."""
    nbytes = b * p + p * 3 * 4 + b * 4 + b * k * 3 * 4
    return float(nbytes), 10.0 * (k - 1) * float(valid_total)


def bound_s(nbytes: float, ops: float) -> tuple:
    """(seconds, which) of the roofline: the larger of bytes over HBM
    bandwidth and operations over the f32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
