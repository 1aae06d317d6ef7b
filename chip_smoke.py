#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``pointcloududa_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``pointcloududa_torch/csrc`` (into the
git-ignored ``build/pointcloududa_torch/``), then runs, in order:

  (a) Chamfer: nearest-neighbour forward and backward kernels against their
      plain PyTorch versions on the card -- B=16, N=M=300; B=2, N=M=2048;
      and a cloud of duplicated points (ties go to the lowest index);
  (b) BN statistics: forward and backward kernels against their plain
      versions at every BatchNorm shape of the generator at bs 16, 224^2;
  (c) the MS-CMRSeg triple-adversary train step (generator + D1 + D2 + D4,
      bs 16, 224^2, float32, both kernels on): five steps on synthetic
      batches, every metric finite, every kernel launched, one step against
      the plain implementations from the same weights, median step time and
      peak memory;
  (d) one evaluation step.

Every check raises on failure, so any failure exits non-zero. The line
before the last is the kernel table as JSON; the last line is
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

STEPS = 5
# one-step kernel-vs-plain agreement of the train-step metrics: the tolerance
# of tests/test_step_parity_torch.py (sum order in f32 reductions differs
# between the kernels and PyTorch's own reductions)
STEP_RTOL, STEP_ATOL = 2e-3, 2e-4

KERNELS = {
    "chamfer_nn_forward": dict(
        route="cuda", source="pointcloududa_torch/csrc/chamfer.cu",
        replaces="pointcloududa_tpu/ops/chamfer_pallas.py:64",
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
}


def _time_ms(torch, fn, iters=20, replays=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events. The replay issues
    the captured launches back to back, so the host's share of a call (the
    Python wrapper, ctypes, allocation) is not in the number, only the
    kernels and the gaps between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def phase_chamfer(torch, dev, rec):
    """(a) Chamfer kernels against their plain versions."""
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops.losses import chamfer_loss as plain_chamfer

    rng = np.random.default_rng(0)
    fwd_err = bwd_err = 0.0
    for b, n in ((16, 300), (2, 2048)):
        x = torch.tensor(rng.uniform(size=(b, n, 3)), dtype=torch.float32, device=dev)
        y = torch.tensor(rng.uniform(size=(b, n, 3)), dtype=torch.float32, device=dev)
        (m1, i1), (m2, i2) = ck.nn_directional(x, y), ck.nn_directional(y, x)
        (p1, j1), (p2, j2) = ck.nn_directional_plain(x, y), ck.nn_directional_plain(y, x)
        _require(torch.equal(i1, j1) and torch.equal(i2, j2), f"argmin mismatch at B={b} N={n}")
        err_min = max(_max_err(m1, p1), _max_err(m2, p2))
        _require(err_min <= 1e-6, f"nn minima differ by {err_min} at B={b} N={n}")
        fwd_err = max(fwd_err, err_min)
        loss, _, _ = ck.chamfer_forward(x, y)
        ref = plain_chamfer(x, y)
        _require(abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref)), f"loss {float(loss)} vs {float(ref)}")
        g = torch.tensor(1.0, device=dev)
        dx, dy = ck.side_grad(x, y, i1, i2, g), ck.side_grad(y, x, i2, i1, g)
        ex, ey = ck.side_grad_plain(x, y, j1, j2, g), ck.side_grad_plain(y, x, j2, j1, g)
        err_grad = max(_max_err(dx, ex), _max_err(dy, ey))
        _require(err_grad <= 1e-6, f"chamfer backward differs by {err_grad} at B={b} N={n}")
        bwd_err = max(bwd_err, err_grad)
        # the autograd path runs both kernels and returns the same gradient
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        ck.chamfer_loss(xg, yg).backward()
        _require(torch.equal(xg.grad, dx) and torch.equal(yg.grad, dy), "autograd gradient differs")
        print(f"  chamfer B={b} N=M={n}: loss {float(loss):.7f} (plain {float(ref):.7f}), "
              f"argmins equal, max|dmin| {err_min:.3g}, max|dgrad| {err_grad:.3g}")
        if n > 512:  # the TPU's tiled regime (N*M > 512^2): time it too
            print(f"  chamfer_nn_forward B={b} N=M={n}: kernel {_time_ms(torch, lambda: ck.nn_directional(x, y)):.4f} ms, "
                  f"plain {_time_ms(torch, lambda: ck.nn_directional_plain(x, y)):.4f} ms")
    # duplicated points: every point appears twice; ties go to the lowest index
    base = torch.tensor(rng.uniform(size=(2, 100, 3)), dtype=torch.float32, device=dev)
    dup = torch.cat([base, base], dim=1).contiguous()
    _, idx = ck.nn_directional(dup, dup)
    _, idx_p = ck.nn_directional_plain(dup, dup)
    want = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    _require(torch.equal(idx, want) and torch.equal(idx_p, want), "duplicate points: ties not lowest-index")
    print("  chamfer duplicated points: argmins are the lowest index (kernel and plain)")

    x = torch.tensor(rng.uniform(size=(16, 300, 3)), dtype=torch.float32, device=dev)
    y = torch.tensor(rng.uniform(size=(16, 300, 3)), dtype=torch.float32, device=dev)
    _, i1 = ck.nn_directional(x, y)
    _, i2 = ck.nn_directional(y, x)
    g = torch.tensor(1.0, device=dev)
    rec["chamfer_nn_forward"].update(
        max_abs_err=fwd_err,
        ms=_time_ms(torch, lambda: ck.nn_directional(x, y)),
        plain_ms=_time_ms(torch, lambda: ck.nn_directional_plain(x, y)),
    )
    rec["chamfer_backward"].update(
        max_abs_err=bwd_err,
        ms=_time_ms(torch, lambda: ck.side_grad(x, y, i1, i2, g)),
        plain_ms=_time_ms(torch, lambda: ck.side_grad_plain(x, y, i1, i2, g)),
    )
    for name in ("chamfer_nn_forward", "chamfer_backward"):
        r = rec[name]
        print(f"  {name} B=16 N=M=300: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")


# every BatchNorm input of the generator at bs 16, 224^2 (encoder and decoder
# levels share the shapes)
BN_SHAPES = ((16, 32, 224, 224), (16, 64, 112, 112), (16, 128, 56, 56), (16, 256, 28, 28))


def phase_bn(torch, dev, rec):
    """(b) BN-statistics kernels against their plain versions."""
    from pointcloududa_torch.ops import bn_kernel as bk

    gen = torch.Generator(device=dev).manual_seed(1)
    fwd_err = bwd_err = 0.0
    timings = []
    for shape in BN_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2
        c = shape[1]
        mk, qk = bk.stats_forward(x)
        mp, qp = bk.stats_forward_plain(x)
        # f32 sums over up to 802,816 values in another order than PyTorch's
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
        t = (
            _time_ms(torch, lambda: bk.stats_forward(x)),
            _time_ms(torch, lambda: bk.stats_forward_plain(x)),
            _time_ms(torch, lambda: bk.stats_backward(x, gm, gq)),
            _time_ms(torch, lambda: bk.stats_backward_plain(x, gm, gq)),
        )
        timings.append(t)
        print(f"  bn_stats {shape}: fwd kernel {t[0]:.4f} ms (plain {t[1]:.4f}), "
              f"bwd kernel {t[2]:.4f} ms (plain {t[3]:.4f})")
        del x, dk, dp
    # the kernel table carries the largest shape, (16, 32, 224, 224)
    rec["bn_stats_forward"].update(max_abs_err=fwd_err, ms=timings[0][0], plain_ms=timings[0][1])
    rec["bn_stats_backward"].update(max_abs_err=bwd_err, ms=timings[0][2], plain_ms=timings[0][3])
    print(f"  bn_stats max|err| fwd {fwd_err:.3g}, bwd {bwd_err:.3g}")


def _launch_counts():
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.ops import chamfer_kernel as ck

    return {
        "chamfer_nn_forward": ck.nn_directional.launches,
        "chamfer_backward": ck.side_grad.launches,
        "bn_stats_forward": bk.stats_forward.launches,
        "bn_stats_backward": bk.stats_backward.launches,
    }


def _reset_launches():
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.ops import chamfer_kernel as ck

    ck.reset_launches()
    bk.reset_launches()


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

    for i, metrics in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not np.isfinite(v)]
        _require(not bad, f"step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(values.items())))
    for name, n in counts.items():
        _require(n > 0, f"kernel {name} was not launched by the train step")
        rec[name]["launches"] = n
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
    print("(a) Chamfer kernels vs plain")
    phase_chamfer(torch, dev, rec)
    print("(b) BN-statistics kernels vs plain")
    phase_bn(torch, dev, rec)
    print("(c) train step")
    cfg = phase_train_step(torch, dev, rec, smi)
    phase_step_parity(torch, dev, cfg)
    print("(d) eval step")
    phase_eval(torch, dev, cfg)

    print(json.dumps({"kernels": list(rec.values())}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
