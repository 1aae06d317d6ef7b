#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``pointcloududa_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``pointcloududa_torch/csrc`` (into the
git-ignored ``build/pointcloududa_torch/``), then runs, in order:

  (a) Chamfer: the one-launch forward, the one-direction nearest-neighbour
      search and the backward kernels against their plain PyTorch versions
      on the card -- B=16, N=M=300; B=2, N=M=2048; N != M (300 x 77); and a
      cloud of duplicated points (ties go to the lowest index); the forward
      timed beside the earlier route (two one-direction launches and five
      PyTorch launches), beside an empty kernel's launch, and in clusters
      of 1 to 8 blocks beside the clusters of each size the card runs at once;
  (b) BN statistics: forward and backward kernels against their plain
      versions, and timed, at every BatchNorm shape of the generator on
      both paths: bs 16 at 224^2 (MS-CMRSeg) and at 256^2 (MM-WHS);
  (c) the MS-CMRSeg triple-adversary train step (generator + D1 + D2 + D4,
      bs 16, 224^2, float32, both kernels on): three steps on synthetic
      batches, every metric finite, every kernel launched, the BatchNorm
      inputs of the shapes phase (b) checked, one step against
      the plain implementations from the same weights, median step time and
      peak memory;
  (d) one evaluation step;
  (e) farthest-point sampling: the kernel against its plain version, bit for
      bit, on B=16 masks of 256^2 with k=300 (filled ellipses; per-pixel
      random labels; every candidate valid, which exceeds the shared-memory
      capacity; a start that is itself invalid), on B=40 clouds, on a mask
      with fewer than k candidates, on an empty and a 50-pixel mask through
      ``masks_to_point_clouds`` (zero clouds), and on general float
      coordinates with P=5,000, k=64; the launch's cluster size and
      shared-memory bytes; its time, also in clusters of 1 to 8 blocks,
      beside a bound that is the larger of bytes, operations and the serial
      chain of k-1 dependent rounds;
  (f) the MM-WHS path at full width (softmax, D2 + D4, bs 16, 256^2,
      5 classes, light augmentation): raw host batch -> device preprocess
      (augment both streams, regenerate both point clouds with the FPS
      kernel, normalise, one-hot) -> train step, four times; every metric
      finite, FPS launched twice per step, the preprocess output checked
      (shapes, one-hot masks, clouds on candidates of the warped masks),
      one preprocess + step against the plain implementations from the same
      weights and generator seeds, preprocess and step times, the
      preprocess time with the point head off (no clouds), peak memory.

Every check raises on failure, so any failure exits non-zero. The line
before the last is the kernel table as JSON (each kernel's time beside its
plain version's, the least time the card could take for the same bytes and
operations, and a library call's time where one computes the same function;
``by_path`` holds each path's launches and, where a kernel's shapes differ
between the paths, its numbers at that path's largest shape);
the last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero and prints no result.

TF32 is switched off for convolutions and matrix products, so float32 means
float32 on both sides of every comparison.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

STEPS = 3
MMWHS_STEPS = 4
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and
# float32 FLOP/s outside the tensor cores; the kernels' bounds are reckoned
# against them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Assumed least cost of one FPS round, whatever the design: the round's point
# is known only after a reduction over the whole cloud (within a block, then
# across the blocks that share the cloud: two barriers and their hand-overs,
# ~1 us at the card's clock), and only then can the next round's pass over
# the distances start. Rounds cannot overlap, so k-1 of them is a floor that
# bytes and operations over the whole card do not see.
FPS_ROUND_FLOOR_US = 1.0
# one-step kernel-vs-plain agreement of the train-step metrics: the tolerance
# of tests/test_step_parity_torch.py (sum order in f32 reductions differs
# between the kernels and PyTorch's own reductions)
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4

KERNELS = {
    "chamfer_forward": dict(
        route="cuda", source="pointcloududa_torch/csrc/chamfer.cu",
        replaces="pointcloududa_tpu/ops/chamfer_pallas.py:64",
    ),
    "chamfer_nn_forward": dict(
        route="cuda", source="pointcloududa_torch/csrc/chamfer.cu",
        replaces="pointcloududa_tpu/ops/chamfer_pallas.py:142",
    ),
    "chamfer_backward": dict(
        route="cuda", source="pointcloududa_torch/csrc/chamfer.cu",
        replaces="pointcloududa_tpu/ops/chamfer_pallas.py:190",
    ),
    "bn_stats_forward": dict(
        route="cuda", source="pointcloududa_torch/csrc/bn_stats.cu",
        replaces="pointcloududa_tpu/ops/bn_pallas.py:96",
    ),
    "bn_stats_backward": dict(
        route="cuda", source="pointcloududa_torch/csrc/bn_stats.cu",
        replaces="pointcloududa_tpu/ops/bn_pallas.py:123",
    ),
    "fps": dict(
        route="cuda", source="pointcloududa_torch/csrc/fps.cu",
        replaces="pointcloududa_tpu/ops/fps_pallas.py:95",
    ),
}


def _bound(nbytes: float, flops: float, chain_ms: float = 0.0) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the HBM peak, its
    operations over the float32 peak, or ``chain_ms``, the time of operations
    that must follow one another, whichever is largest. ``bound_by`` names a
    chain as "operations" (it is the operations' dependence, not their
    number, that binds) and ``bound_note`` says so."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    if chain_ms > max(t_bytes, t_ops):
        return dict(bound_ms=chain_ms, bound_by="operations", bound_note="serial chain",
                    bytes_ms=t_bytes, operations_ms=t_ops)
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _earlier_forward(torch, ck, x, y):
    """The forward as it ran before the one-launch kernel: two one-direction
    launches, then five PyTorch launches. Timed only, beside the new route."""
    min1, _ = ck.nn_directional(x, y)
    min2, _ = ck.nn_directional(y, x)
    return torch.mean(torch.sqrt(min1 + ck.EPS)) + torch.mean(torch.sqrt(min2 + ck.EPS))


def phase_chamfer(torch, dev, rec, card):
    """(a) Chamfer kernels against their plain versions."""
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops.losses import chamfer_loss as plain_chamfer
    from pointcloududa_torch.utils import native
    from pointcloududa_torch.utils.timing import graph_ms

    stream = torch.cuda.current_stream
    floor_ms = graph_ms(lambda: native.check(native.load().pcuda_empty_launch(stream().cuda_stream), "pcuda_empty_launch"))
    print(f"  an empty kernel's launch by graph replay: {floor_ms:.5f} ms (the floor under any one-launch kernel), on {card}")

    rng = np.random.default_rng(0)
    nn_err = fwd_err = bwd_err = 0.0
    for b, n, m in ((16, 300, 300), (2, 2048, 2048), (3, 300, 77)):
        x = torch.tensor(rng.uniform(size=(b, n, 3)), dtype=torch.float32, device=dev)
        y = torch.tensor(rng.uniform(size=(b, m, 3)), dtype=torch.float32, device=dev)
        (m1, i1), (m2, i2) = ck.nn_directional(x, y), ck.nn_directional(y, x)
        (p1, j1), (p2, j2) = ck.nn_directional_plain(x, y), ck.nn_directional_plain(y, x)
        _require(torch.equal(i1, j1) and torch.equal(i2, j2), f"argmin mismatch at B={b} N={n} M={m}")
        err_min = max(_max_err(m1, p1), _max_err(m2, p2))
        _require(err_min <= 1e-6, f"nn minima differ by {err_min} at B={b} N={n} M={m}")
        nn_err = max(nn_err, err_min)
        # the whole forward in one launch: both argmin lists, the per-item means, twice the same bits
        parts, f1, f2 = ck.forward_fused(x, y)
        want_parts, w1, w2 = ck.forward_fused_plain(x, y)
        _require(torch.equal(f1, w1) and torch.equal(f2, w2), f"fused forward: argmin mismatch at B={b} N={n} M={m}")
        err_parts = _max_err(parts, want_parts)
        _require(err_parts <= 1e-6, f"fused forward: loss parts differ by {err_parts} at B={b} N={n} M={m}")
        fwd_err = max(fwd_err, err_parts)
        again = ck.forward_fused(x, y)
        _require(all(torch.equal(u, v) for u, v in zip(again, (parts, f1, f2))), "fused forward not bit-reproducible")
        loss, _, _ = ck.chamfer_forward(x, y)
        ref = plain_chamfer(x, y)
        _require(abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref)), f"loss {float(loss)} vs {float(ref)}")
        g = torch.tensor(1.0, device=dev)
        dx, dy = ck.side_grad(x, y, i1, i2, g), ck.side_grad(y, x, i2, i1, g)
        ex, ey = ck.side_grad_plain(x, y, j1, j2, g), ck.side_grad_plain(y, x, j2, j1, g)
        err_grad = max(_max_err(dx, ex), _max_err(dy, ey))
        _require(err_grad <= 1e-6, f"chamfer backward differs by {err_grad} at B={b} N={n} M={m}")
        bwd_err = max(bwd_err, err_grad)
        # the autograd path runs the fused forward and the backward kernel and returns the same gradient
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = ck.forward_fused.launches, ck.nn_directional.launches
        ck.chamfer_loss(xg, yg).backward()
        _require((ck.forward_fused.launches, ck.nn_directional.launches) == (before[0] + 1, before[1]),
                 "chamfer_loss must make one fused forward launch and no one-direction launch")
        _require(torch.equal(xg.grad, dx) and torch.equal(yg.grad, dy), "autograd gradient differs")
        print(f"  chamfer B={b} N={n} M={m}: loss {float(loss):.7f} (plain {float(ref):.7f}), argmins equal (one-launch "
              f"forward and one-direction search), max|dparts| {err_parts:.3g}, max|dmin| {err_min:.3g}, "
              f"max|dgrad| {err_grad:.3g}, repeat run bit-equal")
        if n > 512:  # the TPU's tiled regime (N*M > 512^2): the one-direction search's row of the table
            rec["chamfer_nn_forward"].update(
                ms=graph_ms(lambda: ck.nn_directional(x, y)), plain_ms=graph_ms(lambda: ck.nn_directional_plain(x, y)),
                library_ms=None, shape=[b, n, m], **_bound(b * (n + m) * 12 + b * n * 8, b * n * m * 9),
            )
            r = rec["chamfer_nn_forward"]
            fused_ms, earlier_ms = graph_ms(lambda: ck.forward_fused(x, y)), graph_ms(lambda: _earlier_forward(torch, ck, x, y))
            print(f"  chamfer_nn_forward B={b} N=M={n}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}; the whole forward there: one launch {fused_ms:.4f} ms, "
                  f"earlier route {earlier_ms:.4f} ms, on {card}")
    rec["chamfer_nn_forward"]["max_abs_err"] = nn_err
    # duplicated points: every point appears twice; ties go to the lowest index
    base = torch.tensor(rng.uniform(size=(2, 100, 3)), dtype=torch.float32, device=dev)
    dup = torch.cat([base, base], dim=1).contiguous()
    _, idx = ck.nn_directional(dup, dup)
    _, idx_p = ck.nn_directional_plain(dup, dup)
    _, f1, f2 = ck.forward_fused(dup, dup)
    want = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    _require(all(torch.equal(got, want) for got in (idx, idx_p, f1, f2)), "duplicate points: ties not lowest-index")
    print("  chamfer duplicated points: argmins are the lowest index (both kernels and plain)")

    x = torch.tensor(rng.uniform(size=(16, 300, 3)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(size=(16, 300, 3)), dtype=torch.float32, device=dev)
    _, i1, i2 = ck.forward_fused(x, y)
    g = torch.tensor(1.0, device=dev)
    b, n, m = 16, 300, 300
    # the whole forward: both clouds in, both argmin lists and two means per
    # item out; each pair's distance once (3 products and 2 sums for the dot,
    # a sum, a product, a difference, a clamp) and a comparison per direction
    rec["chamfer_forward"].update(
        max_abs_err=fwd_err,
        ms=graph_ms(lambda: ck.forward_fused(x, y)),
        plain_ms=graph_ms(lambda: ck.forward_fused_plain(x, y)),
        library_ms=None,
        earlier_ms=graph_ms(lambda: _earlier_forward(torch, ck, x, y)),
        one_direction_ms=graph_ms(lambda: ck.nn_directional(x, y)),
        launch_floor_ms=floor_ms,
        cluster=native.cluster_size(b, dev),
        **_bound(b * (n + m) * 12 + b * (n + m) * 4 + b * 8, b * n * m * 11),
    )
    # backward, one cloud: both clouds, both argmin lists and g in, the
    # gradient out; per point of either cloud one unit vector (~12 operations)
    rec["chamfer_backward"].update(
        max_abs_err=bwd_err,
        ms=graph_ms(lambda: ck.side_grad(x, y, i1, i2, g)),
        plain_ms=graph_ms(lambda: ck.side_grad_plain(x, y, i1, i2, g)),
        library_ms=None,
        **_bound(b * (n + m) * 12 + b * (n + m) * 4 + 4 + b * n * 12, b * (n + m) * 12),
    )
    # the same launch by cluster size: the wrapper's choice rests on where this row steps up (a second wave)
    sizes = range(1, native.MAX_CLUSTER + 1)
    at_once = [native.max_active_clusters(c, dev) for c in sizes]
    r = rec["chamfer_forward"]
    r["by_cluster_ms"] = [graph_ms(lambda: ck._launch_fused(x, y, cluster=c)) for c in sizes]
    print(f"  clusters of 1..8 blocks, one block to an SM, that the card runs at once: {at_once}")
    print(f"  chamfer_forward B=16 N=M=300 in clusters of 1..8 blocks: "
          + ", ".join(f"{t:.4f}" for t in r["by_cluster_ms"]) + f" ms (the wrapper takes {r['cluster']}), on {card}")
    print(f"  chamfer_forward B=16 N=M=300: one launch {r['ms']:.4f} ms in clusters of {r['cluster']} blocks; earlier route (two one-direction launches of "
          f"{r['one_direction_ms']:.4f} ms and five PyTorch launches) {r['earlier_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; "
          f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} (an empty launch costs {floor_ms:.5f} ms), on {card}")
    r = rec["chamfer_backward"]
    print(f"  chamfer_backward B=16 N=M=300: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} (a launch costs more than that)")


# every BatchNorm input of the generator at bs 16, by path: 224^2 for MS-CMRSeg,
# 256^2 for MM-WHS (encoder and decoder levels share the shapes; the 512-channel
# bottleneck has no BatchNorm). Phases (c) and (f) fail if a step's BatchNorm
# inputs are not exactly these.
BN_SHAPES = {
    "mscmrseg": ((16, 32, 224, 224), (16, 64, 112, 112), (16, 128, 56, 56), (16, 256, 28, 28)),
    "mmwhs": ((16, 32, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64), (16, 256, 32, 32)),
}


def phase_bn(torch, dev, rec):
    """(b) BN-statistics kernels against their plain versions, on the shapes
    of both paths."""
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.utils.timing import graph_ms

    gen = torch.Generator(device=dev).manual_seed(1)
    for path, shapes in BN_SHAPES.items():
        fwd_err = bwd_err = 0.0
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2
            c = shape[1]
            mk, qk = bk.stats_forward(x)
            mp, qp = bk.stats_forward_plain(x)
            # f32 sums over up to 1,048,576 values in another order than PyTorch's
            for got, want in ((mk, mp), (qk, qp)):
                err = _max_err(got, want)
                _require(err <= 1e-5 + 1e-5 * float(want.abs().max()), f"BN stats differ by {err} at {shape}")
                fwd_err = max(fwd_err, err)
            mk2, qk2 = bk.stats_forward(x)
            _require(torch.equal(mk, mk2) and torch.equal(qk, qk2), "BN stats not bit-reproducible")
            gm = torch.randn(c, generator=gen, device=dev)
            gq = torch.randn(c, generator=gen, device=dev)
            dk = bk.stats_backward(x, gm, gq)
            dp = bk.stats_backward_plain(x, gm, gq)
            err = _max_err(dk, dp)
            _require(err <= 1e-6 * (1.0 + float(dp.abs().max())), f"BN backward differs by {err} at {shape}")
            bwd_err = max(bwd_err, err)
            # forward: x in, 2 C floats out, 3 operations per element; backward:
            # x and 2 C floats in, dx out, 3 operations per element
            fwd = dict(
                shape=list(shape), ms=graph_ms(lambda: bk.stats_forward(x)),
                plain_ms=graph_ms(lambda: bk.stats_forward_plain(x)),
                # the one PyTorch call that computes the forward's function; a
                # yardstick only, the port never calls it
                library_ms=graph_ms(lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0)),
                **_bound(x.numel() * 4 + 2 * c * 4, 3 * x.numel()),
            )
            bwd = dict(
                shape=list(shape), ms=graph_ms(lambda: bk.stats_backward(x, gm, gq)),
                plain_ms=graph_ms(lambda: bk.stats_backward_plain(x, gm, gq)), library_ms=None,
                **_bound(2 * x.numel() * 4 + 2 * c * 4, 3 * x.numel()),
            )
            print(f"  bn_stats {path} {shape}: fwd kernel {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, "
                  f"torch.var_mean {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f}), bwd kernel {bwd['ms']:.4f} ms "
                  f"(plain {bwd['plain_ms']:.4f}, bound {bwd['bound_ms']:.4f})")
            if shape == shapes[0]:  # the kernel table carries each path's largest shape
                rec["bn_stats_forward"].setdefault("by_path", {})[path] = fwd
                rec["bn_stats_backward"].setdefault("by_path", {})[path] = bwd
            del x, dk, dp
        rec["bn_stats_forward"]["by_path"][path]["max_abs_err"] = fwd_err
        rec["bn_stats_backward"]["by_path"][path]["max_abs_err"] = bwd_err
        print(f"  bn_stats {path} max|err| over its four shapes: fwd {fwd_err:.3g}, bwd {bwd_err:.3g}")
    # the top-level numbers of a row: the largest shape of all, the error over both paths
    for name in ("bn_stats_forward", "bn_stats_backward"):
        by_path = rec[name]["by_path"]
        rec[name].update(by_path["mmwhs"], max_abs_err=max(v["max_abs_err"] for v in by_path.values()))


def _launch_counts():
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops import fps_kernel as fk

    return {
        "chamfer_forward": ck.forward_fused.launches,
        "chamfer_nn_forward": ck.nn_directional.launches,
        "chamfer_backward": ck.side_grad.launches,
        "bn_stats_forward": bk.stats_forward.launches,
        "bn_stats_backward": bk.stats_backward.launches,
        "fps": fk.fps.launches,
    }


def _reset_launches():
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops import fps_kernel as fk

    ck.reset_launches()
    bk.reset_launches()
    fk.reset_launches()


def _record_launches(rec, path: str, counts: dict, expected: set) -> None:
    """Write one path's launch counts into the kernel table and fail if a
    kernel the path runs was launched no time."""
    for name, n in counts.items():
        _require(n > 0 or name not in expected, f"kernel {name} was not launched on the {path} path")
        rec[name].setdefault("by_path", {}).setdefault(path, {})["launches"] = n
        rec[name]["launches"] = rec[name].get("launches", 0) + n


def _watch_bn_inputs(generator_model):
    """Record the shape of every BatchNorm input of the generator from now on;
    returns the set that fills and a function that stops the recording."""
    from pointcloududa_torch.models.unet import TwinBatchNorm

    seen = set()
    hooks = [m.register_forward_pre_hook(lambda _m, args: seen.add(tuple(args[0].shape)))
             for m in generator_model.modules() if isinstance(m, TwinBatchNorm)]
    _require(len(hooks) == 16, f"the generator has {len(hooks)} BatchNorms, not 16")
    return seen, lambda: [h.remove() for h in hooks]


def _to_device(torch, batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def phase_train_step(torch, dev, rec, card):
    """(c) the full-width triple-adversary train step with both kernels."""
    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step

    cfg = mscmrseg_default(
        d1=True, d2=True, d4=True, bs=16, compute_dtype="float32",
        chamfer_impl="pallas", bn_stats_impl="pallas",
    )
    state = create_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, state.models, state.optimizers)
    batches = [_to_device(torch, synthetic_batch(cfg, cfg.bs, seed=s), dev) for s in range(STEPS)]
    bn_seen, stop_watching = _watch_bn_inputs(state.models[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _reset_launches()
    times, history = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch)
        end.record()
        history.append(metrics)
        end.synchronize()
        times.append(start.elapsed_time(end))
    counts = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stop_watching()
    _require(bn_seen == set(BN_SHAPES["mscmrseg"]), f"BatchNorm inputs {sorted(bn_seen)} are not phase (b)'s shapes")

    for i, metrics in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not np.isfinite(v)]
        _require(not bad, f"step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(values.items())))
    # the one-direction search serves large clouds only: no path runs it
    _record_launches(rec, "mscmrseg", counts, set(counts) - {"fps", "chamfer_nn_forward"})
    _require(counts["fps"] == 0, "the MS-CMRSeg step regenerates no clouds")
    _require((counts["chamfer_forward"], counts["chamfer_nn_forward"], counts["chamfer_backward"]) == (2 * STEPS, 0, STEPS),
             f"per step the Chamfer loss must launch 2 fused forwards, no one-direction search and 1 backward: {counts}")
    print(f"  launches in {STEPS} steps: {counts}")
    # the first step pays cuDNN's algorithm choice and the allocator's growth
    print(f"  train step (bs 16, 224^2, f32, D1+D2+D4, both kernels): median {statistics.median(times[1:]):.2f} ms "
          f"over steps 1-{STEPS - 1} (all: {', '.join(f'{t:.2f}' for t in times)}), "
          f"peak memory {peak_gib:.2f} GiB, on {card}")
    return cfg


def phase_step_parity(torch, dev, cfg):
    """(c, cont.) one step from identical weights: kernels vs plain impls."""
    import dataclasses

    from pointcloududa_torch.data.synthetic import synthetic_batch
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    batch = _to_device(torch, synthetic_batch(cfg, cfg.bs, seed=11), dev)
    results = {}
    for name, c in (
        ("kernels", cfg),
        ("plain", dataclasses.replace(cfg, chamfer_impl="jnp", bn_stats_impl="xla")),
    ):
        state = create_train_state(c, seed=0, device=dev)
        step = make_train_step(c, state.models, state.optimizers)
        _, metrics = step(state, batch)
        results[name] = {k: float(v) for k, v in metrics.items()}
        del state, step
    worst = 0.0
    for key, want in results["plain"].items():
        got = results["kernels"][key]
        _require(abs(got - want) <= STEP_ATOL + STEP_RTOL * abs(want), f"step metric {key}: kernels {got} vs plain {want}")
        worst = max(worst, abs(got - want))
    print(f"  one step, kernels vs plain from identical weights: {len(results['plain'])} metrics agree "
          f"(max |diff| {worst:.3g}; rtol {STEP_RTOL}, atol {STEP_ATOL}; cuDNN deterministic)")
    torch.backends.cudnn.deterministic = False


def phase_eval(torch, dev, cfg):
    """(d) one evaluation step."""
    from pointcloududa_torch.data.synthetic import synthetic_eval_batch
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_eval_step

    state = create_train_state(cfg, seed=0, device=dev)
    eval_step = make_eval_step(cfg, state.models[0])
    out = eval_step(_to_device(torch, synthetic_eval_batch(cfg, cfg.bs), dev))
    logits = out["logits"]
    _require(tuple(logits.shape) == (cfg.bs, cfg.crop_size, cfg.crop_size, cfg.n_class), f"logits {tuple(logits.shape)}")
    _require(bool(torch.isfinite(logits).all()), "non-finite eval logits")
    vals = {k: float(out[k]) for k in ("loss", "dice", "vert_loss")}
    _require(all(np.isfinite(v) for v in vals.values()) and 0.0 <= vals["dice"] <= 1.0, f"eval metrics {vals}")
    print(f"  eval step: logits {tuple(logits.shape)}, " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))


def _on_candidates(torch, clouds, masks) -> bool:
    """Whether every point of (B, k, 3) voxel clouds is a candidate of its
    (B, H, W) mask: a foreground pixel on the z=0 and z=2 faces, a boundary
    pixel at z=1."""
    from pointcloududa_torch.ops.pointcloud_device import candidates

    b, h, w = masks.shape
    cand = candidates(masks > 0).reshape(b, 3, h, w)
    z, y, x = clouds.round().long().unbind(-1)
    item = torch.arange(b, device=masks.device)[:, None]
    return bool(cand[item, z, y, x].all())


def phase_fps(torch, dev, rec, card):
    """(e) the FPS kernel against its plain version, bit for bit."""
    from pointcloududa_torch.config import mmwhs_default
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks, synthetic_raw_batch
    from pointcloududa_torch.ops import fps_kernel as fk
    from pointcloududa_torch.ops import pointcloud_device as pcd
    from pointcloududa_torch.utils import native
    from pointcloududa_torch.utils.timing import graph_ms

    size, b, k = 256, 16, 300
    coords = pcd.grid_coords(size, size, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    cfg = mmwhs_default(d4=True)
    few = np.zeros((2, size, size), np.uint8)
    few[0, 100:108, 60:72] = 3  # 96 pixels: 2 * 96 face + 36 ring candidates < k
    few[1, 5:12, 200:209] = 1
    ellipses = torch.as_tensor(synthetic_blob_masks(b, size, seed=0), device=dev)
    ellipse_cand = pcd.candidates(ellipses > 0)
    # name -> (masks or None, candidates, starts); starts None: drawn among the candidates
    cases = {
        "ellipses": (ellipses, ellipse_cand, None),
        "random labels": (torch.as_tensor(synthetic_raw_batch(cfg, b, seed=0)["mask_s"], device=dev), None, None),
        "fewer than k candidates": (torch.as_tensor(few, device=dev), None, None),
        # every candidate valid: 24,576 or more a block, beyond what its shared memory holds
        "every candidate valid": (None, torch.ones_like(ellipse_cand), pcd.draw_starts(ellipses, gen)),
        # the first point is coords[start] whether or not start is valid
        "invalid start": (None, ellipse_cand, torch.argmin(ellipse_cand.to(torch.int32), dim=1).to(torch.int32)),
        # more clouds than the card runs clusters at once
        "B=40": (torch.as_tensor(synthetic_blob_masks(40, size, seed=5), device=dev), None, None),
    }
    geometry = fk.launch_geometry(b, 3 * size * size, dev)
    print(f"  fps launch at B={b} P={3 * size * size}: a cluster of {geometry['cluster']} blocks of {geometry['threads']} "
          f"threads per cloud ({geometry['clusters_at_once']} such clusters run at once on this card; 8 blocks: "
          f"{native.max_active_clusters(8, dev)}), {geometry['shared_bytes']} bytes of shared memory a block = "
          f"{geometry['capacity']} candidates resident, up to {geometry['overflow']} more in its scratch row; "
          f"at B=40: clusters of {native.cluster_size(40, dev)}")
    timed, worst = {}, 0.0
    for name, (masks, cand, starts) in cases.items():
        if cand is None:
            cand = pcd.candidates(masks > 0)
        if starts is None:
            starts = pcd.draw_starts(masks, gen)
        grid = coords.expand(cand.shape[0], -1, -1)  # batch stride 0: one grid for all
        got, want = fk.fps(cand, grid, starts, k), fk.fps_plain(cand, grid, starts, k)
        torch.cuda.synchronize()
        worst = max(worst, _max_err(got, want))
        _require(torch.equal(got, want), f"FPS kernel differs from its plain version on {name}")
        _require(bool(torch.isfinite(got).all()), f"FPS points not finite on {name}")
        if masks is not None:
            _require(_on_candidates(torch, got, masks), f"FPS points off the candidates on {name}")
        if name == "invalid start":
            first = got[:, 0].round().long()
            _require(not bool(cand[torch.arange(b, device=dev), (first[:, 0] * size + first[:, 1]) * size + first[:, 2]].any()),
                     "this case must start off the candidates")
        n_valid = cand.sum(1)
        distinct = [len({tuple(pt) for pt in cloud.tolist()}) for cloud in got[:2]]
        print(f"  fps {name}: B={cand.shape[0]} P={cand.shape[1]} k={k}, kernel == plain; valid candidates per cloud "
              f"{int(n_valid.min())}..{int(n_valid.max())}; distinct points in clouds 0, 1: {distinct}")
        if name == "fewer than k candidates":
            _require(max(distinct) < k and int(n_valid.max()) < k, "this case must run out of candidates")
        if name == "every candidate valid":
            _require(int(n_valid.min()) > geometry["cluster"] * geometry["capacity"], "this case must exceed the shared memory")
        if name not in ("invalid start", "B=40"):
            timed[name] = (cand, grid, starts, float(n_valid.sum()))

    # zero clouds: an empty mask and a mask of exactly 50 pixels, beside a live one
    masks = torch.zeros((3, size, size), dtype=torch.uint8, device=dev)
    masks[1, 0, :50] = 1
    masks[2] = torch.as_tensor(synthetic_blob_masks(1, size, seed=1)[0], device=dev)
    got = pcd.masks_to_point_clouds(masks, torch.Generator(device=dev).manual_seed(3))
    want = pcd.masks_to_point_clouds(masks, torch.Generator(device=dev).manual_seed(3), impl="plain")
    worst = max(worst, _max_err(got, want))
    _require(torch.equal(got, want), "masks_to_point_clouds: kernel and plain differ")
    _require(not bool(got[:2].any()) and bool(got[2].any()), "empty and 50-pixel masks must give zero clouds")
    print("  fps empty and 50-pixel masks: zero clouds, the live mask beside them sampled (kernel == plain)")

    # general float coordinates, P not a multiple of 128, own coordinates per cloud
    rng = np.random.default_rng(4)
    fb, fp, fkk = 4, 5000, 64
    fcoords = torch.tensor(rng.normal(size=(fb, fp, 3)), dtype=torch.float32, device=dev)
    fvalid = torch.tensor(rng.uniform(size=(fb, fp)) < 0.7, device=dev)
    fstarts = torch.argmax(fvalid.to(torch.int32), dim=1).to(torch.int32)
    got, want = fk.fps(fvalid, fcoords, fstarts, fkk), fk.fps_plain(fvalid, fcoords, fstarts, fkk)
    worst = max(worst, _max_err(got, want))
    _require(torch.equal(got, want), "FPS kernel differs from its plain version on float coordinates")
    print(f"  fps float coordinates: B={fb} P={fp} k={fkk}, kernel == plain; max|err| over all cases {worst}")

    # times at the path's shape; the plain version is a Python loop of k
    # rounds of ~10 PyTorch kernels, so one call is captured, not 20
    chain_ms = (k - 1) * FPS_ROUND_FLOOR_US * 1e-3
    for name, (cand, grid, starts, n_valid) in timed.items():
        nb = cand.shape[0]
        ms = graph_ms(lambda: fk.fps(cand, grid, starts, k), iters=3, replays=3)
        plain_ms = graph_ms(lambda: fk.fps_plain(cand, grid, starts, k), iters=1, replays=2)
        # bytes: validity, the shared grid and the starts in, the clouds out;
        # operations: k-1 rounds over this batch's valid candidates, each 3
        # subtractions, 3 products, 2 sums, a minimum and a comparison; chain:
        # k-1 rounds that cannot overlap
        bound = _bound(cand.numel() + coords.numel() * 4 + nb * 4 + nb * k * 12, (k - 1) * n_valid * 10, chain_ms)
        print(f"  fps {name} B={nb} P={cand.shape[1]} k={k}: kernel {ms:.4f} ms (3 calls captured, 3 replays), "
              f"plain {plain_ms:.4f} ms (1 call captured, 2 replays), bound {bound['bound_ms']:.4f} ms by "
              f"{bound.get('bound_note', bound['bound_by'])} ({k - 1} rounds x {FPS_ROUND_FLOOR_US} us assumed; bytes "
              f"{bound.get('bytes_ms', 0.0):.4f} ms, operations {bound.get('operations_ms', 0.0):.4f} ms; "
              f"{n_valid / nb:.0f} valid candidates per cloud), on {card}")
        if name == "ellipses":  # the kernel table carries the masks that look like anatomy
            rec["fps"].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                              cluster=geometry["cluster"], shared_bytes=geometry["shared_bytes"], **bound)
            rec["fps"]["by_cluster_ms"] = [graph_ms(lambda: fk._launch(cand, grid, starts, k, cluster=c), iters=3, replays=3)
                                           for c in range(1, native.MAX_CLUSTER + 1)]
            print(f"  fps ellipses B={nb} in clusters of 1..8 blocks: " + ", ".join(f"{t:.4f}" for t in rec["fps"]["by_cluster_ms"])
                  + f" ms (the wrapper takes {geometry['cluster']}), on {card}")
    # what a round of this kernel costs with next to nothing to sweep: one
    # candidate per thread of one block (the other blocks of the cluster hold
    # none), so the reductions, the hand-over and the barriers remain
    tiny = torch.ones((b, 1024), dtype=torch.bool, device=dev)
    tcoords = torch.tensor(rng.normal(size=(b, 1024, 3)), dtype=torch.float32, device=dev)
    tstarts = torch.zeros(b, dtype=torch.int32, device=dev)
    _require(torch.equal(fk.fps(tiny, tcoords, tstarts, k), fk.fps_plain(tiny, tcoords, tstarts, k)),
             "FPS kernel differs from its plain version at P=1024")
    ms = graph_ms(lambda: fk.fps(tiny, tcoords, tstarts, k), iters=3, replays=3)
    print(f"  fps one candidate per thread B={b} P=1024 k={k}: kernel {ms:.4f} ms = {ms * 1e3 / (k - 1):.2f} us a round "
          f"(the measured chain of this design, beside the {FPS_ROUND_FLOOR_US} us assumed for the bound), on {card}")
    rec["fps"]["max_abs_err"] = worst  # over every case above


def phase_mmwhs(torch, dev, rec, card):
    """(f) the MM-WHS path: raw batch -> device preprocess -> train step."""
    import dataclasses

    from pointcloududa_torch.config import mmwhs_default
    from pointcloududa_torch.data.synthetic import synthetic_raw_batch
    from pointcloududa_torch.ops import augment
    from pointcloududa_torch.train.loop import make_device_preprocess
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils.timing import event_ms

    cfg = mmwhs_default(
        softmax=True, d2=True, d4=True, aug="light", bs=16, compute_dtype="float32",
        chamfer_impl="pallas", bn_stats_impl="pallas",
    )
    _require((cfg.crop_size, cfg.n_class, cfg.fc_inch) == (256, 5, 121), "not the MM-WHS widths")
    state = create_train_state(cfg, seed=0)  # no device given: the card
    _require(next(state.models[0].parameters()).device.type == "cuda", "the default device is not the card")
    step = make_train_step(cfg, state.models, state.optimizers)
    preprocess = make_device_preprocess(cfg, train=True, device_augment=True)
    bn_seen, stop_watching = _watch_bn_inputs(state.models[0])
    gen = torch.Generator(device=dev).manual_seed(7)
    # the raw batches wait on the card, as a prefetching loader leaves them
    raws = [_to_device(torch, synthetic_raw_batch(cfg, cfg.bs, seed=s), dev) for s in range(MMWHS_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    _reset_launches()
    pre_ms, step_ms, history = [], [], []
    for raw in raws:
        batch, t = event_ms(lambda: preprocess(gen, raw))
        pre_ms.append(t)
        (state, metrics), t = event_ms(lambda: step(state, batch))
        step_ms.append(t)
        history.append(metrics)
    counts = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stop_watching()
    _require(bn_seen == set(BN_SHAPES["mmwhs"]), f"BatchNorm inputs {sorted(bn_seen)} are not phase (b)'s shapes")

    for i, metrics in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not np.isfinite(v)]
        _require(not bad, f"MM-WHS step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(values.items())))
    _require(counts["fps"] == 2 * MMWHS_STEPS, f"fps launched {counts['fps']} times in {MMWHS_STEPS} steps, not twice per step")
    _require((counts["chamfer_forward"], counts["chamfer_nn_forward"], counts["chamfer_backward"])
             == (2 * MMWHS_STEPS, 0, MMWHS_STEPS),
             f"per step the Chamfer loss must launch 2 fused forwards, no one-direction search and 1 backward: {counts}")
    _record_launches(rec, "mmwhs", counts, set(counts) - {"chamfer_nn_forward"})
    print(f"  launches in {MMWHS_STEPS} preprocess + step calls: {counts}")
    # the first call pays cuDNN's algorithm choice and the allocator's growth
    print(f"  MM-WHS device preprocess (bs 16, 256^2, light augmentation of both streams + 32 clouds by the FPS "
          f"kernel): median {statistics.median(pre_ms[1:]):.2f} ms over calls 1-{MMWHS_STEPS - 1} "
          f"(all: {', '.join(f'{t:.2f}' for t in pre_ms)}), on {card}")
    print(f"  MM-WHS train step (bs 16, 256^2, f32, softmax, D2+D4, all kernels): median "
          f"{statistics.median(step_ms[1:]):.2f} ms over steps 1-{MMWHS_STEPS - 1} "
          f"(all: {', '.join(f'{t:.2f}' for t in step_ms)}), peak memory {peak_gib:.2f} GiB, on {card}")

    # the same preprocess with the point head off: no clouds, so no FPS launch
    no_clouds = make_device_preprocess(dataclasses.replace(cfg, d4=False), train=True, device_augment=True)
    bare_ms = [event_ms(lambda: no_clouds(gen, raw))[1] for raw in raws]
    _require(_launch_counts()["fps"] == counts["fps"], "the point head is off: no cloud may be regenerated")
    print(f"  MM-WHS device preprocess with the point head off (augmentation, normalise, one-hot; no clouds): median "
          f"{statistics.median(bare_ms[1:]):.2f} ms over calls 1-{MMWHS_STEPS - 1} "
          f"(all: {', '.join(f'{t:.2f}' for t in bare_ms)}), on {card}")

    # the preprocess output, with the draws in hand so the warped masks are known
    light = augment.light()
    raw = raws[0]
    draws = {f"aug_{side}": augment.sample_draws(gen, light, cfg.bs, dev) for side in ("s", "t")}
    batch = preprocess(gen, raw, draws=draws)
    hw = cfg.crop_size
    want = {"img_s": (cfg.bs, hw, hw, 3), "img_t": (cfg.bs, hw, hw, 3), "mask_s": (cfg.bs, hw, hw, cfg.n_class),
            "vert_s": (cfg.bs, 300, 3), "vert_t": (cfg.bs, 300, 3)}
    _require({k: tuple(v.shape) for k, v in batch.items()} == want, f"preprocess shapes {[(k, tuple(v.shape)) for k, v in batch.items()]}")
    _require(all(v.dtype == torch.float32 and v.device.type == "cuda" and bool(torch.isfinite(v).all()) for v in batch.values()),
             "preprocess output must be finite float32 on the card")
    _require(bool((batch["mask_s"].sum(-1) == 1).all()), "one-hot masks must sum to 1 per pixel")
    blank = torch.zeros((cfg.bs, hw, hw, 1), device=dev)
    for side in ("s", "t"):
        cloud = batch[f"vert_{side}"]
        _require(float(cloud.min()) >= 0.0 and float(cloud.max()) <= 1.0, f"vert_{side} outside [0, 1]")
        _, warped = augment.augment_from_draws(light, blank, raw[f"mask_{side}"], draws[f"aug_{side}"])
        _require(_on_candidates(torch, cloud * 255.0, warped), f"vert_{side}: a point off the warped mask's candidates")
    _require(torch.equal(batch["mask_s"].argmax(-1).to(torch.int32), augment.augment_from_draws(
        light, blank, raw["mask_s"], draws["aug_s"])[1]), "mask_s is not the warped source mask")
    fired = draws["aug_s"]["gates"].sum(0).tolist()
    print(f"  preprocess output: shapes and dtypes as the step takes them, one-hot masks sum to 1, clouds in [0, 1] "
          f"and on candidates of the warped masks (source stream: {fired[0]} fliplr, {fired[1]} flipud, {fired[3]} affine of {cfg.bs})")

    # one preprocess + step from identical weights and generator seeds: all
    # kernels against all plain implementations
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    results = {}
    for name, c, fps_impl in (
        ("kernels", cfg, "auto"),
        ("plain", dataclasses.replace(cfg, chamfer_impl="jnp", bn_stats_impl="xla"), "plain"),
    ):
        st = create_train_state(c, seed=0)
        b = make_device_preprocess(c, True, True, fps_impl=fps_impl)(torch.Generator(device=dev).manual_seed(11), raws[1])
        _, metrics = make_train_step(c, st.models, st.optimizers)(st, b)
        results[name] = (b, {k: float(v) for k, v in metrics.items()})
        del st
    torch.backends.cudnn.deterministic = False
    for key in ("vert_s", "vert_t"):
        _require(torch.equal(results["kernels"][0][key], results["plain"][0][key]), f"{key}: kernel and plain clouds differ")
    worst = 0.0
    for key, want_v in results["plain"][1].items():
        got_v = results["kernels"][1][key]
        _require(abs(got_v - want_v) <= STEP_ATOL + STEP_RTOL * abs(want_v), f"MM-WHS step metric {key}: kernels {got_v} vs plain {want_v}")
        worst = max(worst, abs(got_v - want_v))
    print(f"  one preprocess + step, kernels vs plain from identical weights and seeds: clouds equal bit for bit, "
          f"{len(results['plain'][1])} metrics agree (max |diff| {worst:.3g}; rtol {STEP_RTOL}, atol {STEP_ATOL}; cuDNN deterministic)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from pointcloududa_torch.utils import native

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: torch.backends.cudnn.allow_tf32 = False, torch.backends.cuda.matmul.allow_tf32 = False")

    t0 = time.perf_counter()
    native.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {native.library_path()}")
    usage = [ln.strip() for ln in native.build_log.splitlines() if "registers" in ln or "Compiling entry" in ln]
    for ln in usage:
        print(f"  ptxas: {ln}")

    rec = {name: dict(name=name, **meta) for name, meta in KERNELS.items()}
    seconds = {"build": time.perf_counter() - t0}
    print("(a) Chamfer kernels vs plain")
    t0 = time.perf_counter()
    phase_chamfer(torch, dev, rec, smi)
    seconds["a"] = time.perf_counter() - t0
    print("(b) BN-statistics kernels vs plain")
    t0 = time.perf_counter()
    phase_bn(torch, dev, rec)
    seconds["b"] = time.perf_counter() - t0
    print("(c) train step")
    t0 = time.perf_counter()
    cfg = phase_train_step(torch, dev, rec, smi)
    phase_step_parity(torch, dev, cfg)
    seconds["c"] = time.perf_counter() - t0
    print("(d) eval step")
    t0 = time.perf_counter()
    phase_eval(torch, dev, cfg)
    seconds["d"] = time.perf_counter() - t0
    print("(e) FPS kernel vs plain")
    t0 = time.perf_counter()
    phase_fps(torch, dev, rec, smi)
    seconds["e"] = time.perf_counter() - t0
    print("(f) MM-WHS path: raw batch -> device preprocess -> train step")
    t0 = time.perf_counter()
    phase_mmwhs(torch, dev, rec, smi)
    seconds["f"] = time.perf_counter() - t0
    print("host seconds by phase: " + ", ".join(f"{name} {t:.1f}" for name, t in seconds.items()))

    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for r in rec.values():
        _require(keys <= set(r), f"kernel {r['name']} lacks {sorted(keys - set(r))}")
    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
