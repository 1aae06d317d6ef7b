"""The U-Net generator (``reference/unet.py``): the dense-skip U-Net with a
dilated bottleneck and the point head, the port's ``models/unet.py``. Its
layers are the base rules' kinds, so it adds no ``INIT_RULES``."""

from __future__ import annotations

from perfbench.reference.unet import SegmentationPointModel


def build_generator(cfg, generator, compute_dtype):
    return SegmentationPointModel(
        filters=cfg.filters,
        in_channels=cfg.in_channels,
        n_block=cfg.n_block,
        bottleneck_depth=cfg.bottleneck_depth,
        n_class=cfg.n_class,
        pointnet=cfg.point_head,
        fc_inch=cfg.fc_inch,
        extpn=cfg.extpn,
        batchnorm=cfg.batchnorm,
        drop=cfg.drop,
        heinit=cfg.heinit,
        bn_kernel=cfg.bn_stats_impl == "pallas",
        generator=generator,
        compute_dtype=compute_dtype,
    )


def generator_flops(c, cfg, b: int, train: bool) -> None:
    """One forward of the U-Net generator (and point head) on a (b, S, S)
    batch; ``train``: the pass trains its weights."""
    f, s = cfg.filters, cfg.crop_size
    x_grad = False  # the image needs no gradient
    for i in range(cfg.n_block):
        out_ch, in_ch = f * 2**i, (cfg.in_channels if i == 0 else f * 2 ** (i - 1))
        x_grad = c.conv(b, in_ch, out_ch, 3, s, s, x_grad, train)
        x_grad = c.conv(b, out_ch, out_ch, 3, s, s, x_grad, train)
        if i > 0:
            x_grad = c.conv(b, out_ch + in_ch, out_ch, 1, s, s, x_grad, train)
        s //= 2
    deep = f * 2**cfg.n_block
    for i in range(cfg.bottleneck_depth):
        x_grad = c.conv(b, f * 2 ** (cfg.n_block - 1) if i == 0 else deep, deep, 3, s, s, x_grad, train)
    if cfg.d4 or cfg.d4aux:
        y = deep
        if cfg.extpn:
            conv_inch = 512 * f // 32
            c.conv(b, deep, 2 * conv_inch, 3, s, s, x_grad, train)
            c.conv(b, 2 * conv_inch, conv_inch, 3, s, s, x_grad, train)
            y = conv_inch
        c.conv(b, y, 300, 6, s - 5, s - 5, x_grad, train)
        c.product(2.0 * b * 300 * cfg.fc_inch * 3, x_grad, train)
    for i in reversed(range(cfg.n_block)):
        s *= 2
        out_ch = f * 2**i
        c.conv(b, f * 2 ** (i + 1), out_ch, 3, s, s, x_grad, train)
        c.conv(b, 2 * out_ch, out_ch, 3, s, s, x_grad, train)
        c.conv(b, out_ch, out_ch, 3, s, s, x_grad, train)
    c.conv(b, f, cfg.n_class, 1, s, s, x_grad, train)
