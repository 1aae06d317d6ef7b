#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``pointcloududa_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``pointcloududa_torch/csrc`` with nvcc and,
at the same time, the host library (``csrc/pcuda_host.cpp``) with g++ (both
into the git-ignored ``build/pointcloududa_torch/``), then runs, in order:

  (a) Chamfer: the one-launch forward, the one-direction nearest-neighbour
      search and the backward kernels against their plain PyTorch versions
      on the card -- B=16, N=M=300; B=2, N=M=2048; N != M (300 x 77); B=40
      (more blocks than one wave); a cloud of duplicated points (ties go to
      the lowest index; points that no partner chose) and one point chosen
      by every partner; the backward run twice for equal bits, and timed
      with 1 to 32 threads a point beside the wrapper's choice; the loss on
      the route the TPU package takes (the fused forward up to 512 x 512
      pairs, two one-direction searches above); the forward timed beside
      the large-cloud route, beside an empty kernel's launch, and in
      clusters of 1 to 8 blocks beside the clusters of each size the card
      runs at once. The one-direction search (``nn_kernel``) at (B, N, M) =
      (2, 2048, 2048), (16, 2048, 2048), (1, 8192, 8192), (2, 600, 530),
      (16, 300, 300), (3, 257, 40), (1, 1, 5) on uniform and on
      integer-grid (tie-heavy) clouds: argmins equal and minima bit-equal
      to the plain version's, repeat runs bit-equal; every launch plan
      forced once (lanes 1..32 x clusters 1..8)
      on a tie-heavy cloud and on duplicated points; a plan the kernel
      cannot take refused; at the first three shapes its time beside the
      plain version's, its bound (the instructions the function needs),
      what its SASS issues a pair, ``torch.cdist`` +
      ``min`` (two calls, printed only), both routes' whole forward and the
      time by plan; then the large-cloud path (``by_path.chamfer_large``):
      ``chamfer_loss(x, y).backward()`` at (2, 2048, 2048) with exactly 2
      one-direction, 0 fused and 2 backward launches, its loss and
      gradients against the plain versions;
  (b) BN statistics: forward and backward kernels against their plain
      versions, and timed, at every BatchNorm shape of the generator on
      both paths: bs 16 at 224^2 (MS-CMRSeg) and at 256^2 (MM-WHS), for a
      float32 and a bfloat16 activation (f32 statistics at the f32
      sum-order tolerance, a bf16 dx within 1 bf16 ulp of the plain
      version's, both bit-equal on a repeat, each call one CUDA kernel in a
      profiler trace), and a float16 one refused; each time beside its
      bound, the plain version's and the library call's (``torch.var_mean``
      forward, ``torch.addcmul`` backward), the launch plan at each shape
      (cluster size, values a load, the card's clusters at once), the
      forward in clusters of 1, 2, 4, 8 and the backward in one wave at the
      32-channel bf16 shapes;
  (c) the MS-CMRSeg triple-adversary train step (generator + D1 + D2 + D4,
      bs 16, 224^2, float32, both kernels on): four steps on synthetic
      batches (the first eager, the second captures both CUDA graphs of the
      step, the last two replay them), every metric finite, every kernel
      launched, the BatchNorm inputs of the shapes phase (b) checked, one
      step against the plain implementations from the same weights, the
      median replayed step's time beside the capture's, and peak memory;
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
      preprocess time with the point head off (no clouds), peak memory;
  (g) the training run at full width, through the command-line entry point
      a user calls: an MM-WHS dataset of 32 + 32 training and 16 + 16
      validation slices (256^2 x 3 float images, 5-class masks of filled
      ellipses, 300-point vertex files, the four datalists) is fabricated
      from a seed into a temporary directory that the phase removes, and
      ``pointcloududa_torch.cli.train_mmwhs.main`` trains on it for 2 epochs
      of 4 steps (bs 16, nf 32, light augmentation, softmax, D2 + D4, the
      target cloud's diagnostic every 2nd step, a full snapshot per epoch),
      each epoch with its three validations, then the final evaluation of
      its best checkpoint on four fabricated CT test volumes (256 x 256 x
      32, four ellipsoid structures): every logged scalar finite, the
      checkpoint files present under the reference's names and loadable,
      every kernel's launch count equal to what steps, cadence and validation
      batches give (the evaluation adds none), ``Ave Dice`` printed and every
      metric finite or the -1 sentinel, seconds per patient on the card and
      on the host; seconds per epoch and ms per training iteration beside
      phase (f)'s preprocess + step. Then, with cuDNN deterministic (at its
      defaults two runs from one seed part ways within an epoch), the same
      2 epochs again, a second call that resumes from the snapshot at epoch
      3, and its scalars held against an uninterrupted 3-epoch run in other
      directories;
  (h) the heavy and medium augmentation pipelines (the MS-CMRSeg default:
      ``-aug`` absent) at full width: MS-CMRSeg D1+D2+D4, bs 16, 4 classes,
      raw 256^2 x 3 uint8 slices (the reference's processed PNG size) ->
      device preprocess with heavy augmentation of both streams -> centre
      crop to 224^2 -> train step, four times: every metric finite, labels in
      {0..3}, images in [0, 1], each kernel launched as often as phase (c)'s
      steps say; one heavy preprocess under
      ``torch.cuda.set_sync_debug_mode("error")`` and one behind half a
      second of queued work that must return before the card wakes (no
      host-device synchronisation); one medium preprocess + step; the
      preprocess time of heavy, medium, light and no augmentation beside the
      step; two MM-WHS ``-aug heavy`` preprocess + step calls (softmax D2+D4,
      256^2) with FPS launched twice a step and the clouds on the candidates
      of the warped masks; the heavy call on the card held against the same
      call on the CPU from one set of draws (drawn; every member but the
      superpixels; the superpixels alone), at the CPU tests' tolerances; each
      of the 15 SomeOf members (and the blur's three kinds) forced on for the
      whole batch and timed alone;
  (i) the reference's MS-CMRSeg command through
      ``pointcloududa_torch.cli.train_mscmrseg.main`` without ``-aug`` (the
      heavy pipeline) and with ``-d1 -d2 -d4``: a dataset of 32 + 32 training
      and 16 + 16 validation PNG slices (256^2 x 3, written by
      ``utils/png.py``), masks in {0, 85, 212, 255}, 300-point vertex files
      and the four datalists, fabricated into a temporary directory that the
      phase removes; 2 epochs of 4 steps at bs 16 with the checks of phase
      (g) (scalars, checkpoint names, launch counts from steps and
      validation batches, ms per iteration beside phase (h)'s preprocess +
      step), and, with cuDNN deterministic, a resumed epoch 3 that must equal
      an uninterrupted run's bit for bit (phase (g)'s code);
  (j) evaluation at full width, in float32, on test patients fabricated
      into a temporary directory (removed after phase (k), which reads them
      again): ``cli.evaluate_mscmrseg.main -klc
      -clahe -toplot -csv`` on phase (i)'s best generator (nf 32, 224^2) over
      two LGE patients (256^2 PNG slices; ground truth 480 x 480 x 12, which
      the resize enlarges to, and 208 x 240 x 10, which it shrinks to by
      factors that are not integers), the triptychs and CSV rows written; the
      same weights saved again in the reference's callback layout with
      torch 1.4's serialisation give equal labels and metrics; the same
      evaluation on the CPU, whose label volumes may differ from the card's
      in at most ``LABEL_SHARE`` of a patient's voxels and whose metrics
      equal the card's wherever the labels do, and the same comparison for
      an untrained generator from a seed saved as a bare ``state_dict``
      (Dice only), whose labels are not nearly all background as the
      trained one's are; ``cli.evaluate_mmwhs.main
      -from_name -save`` on phase (g)'s best generator, equal to phase (g)'s
      final evaluation; ``Predictor`` at nf 32, bs 8, 224^2 and 256^2 (tail
      padding, card against CPU, ms per batch between CUDA events and images
      per second) and ``export_predictor`` -> ``load_exported`` on the card
      against it (artifact bytes, load seconds); per patient the forward's
      and the host's seconds, the host's by step; and no kernel launched on
      the evaluation path (eval mode normalises with running statistics);
  (k) ``compute_dtype="bfloat16"`` at full width, every kernel on: the
      MS-CMRSeg D1+D2+D4 step (bs 16, 224^2) and the MM-WHS softmax D2+D4
      raw batch -> device preprocess (FPS) -> step (bs 16, 256^2), each
      five times in float32 and five in bfloat16 in this call (median step
      time, peak memory, the BatchNorm inputs bf16 at phase (b)'s shapes,
      the bf16 BN kernels launched 32 times a step and the f32 ones never),
      then once more under the profiler (device time by kernel kind, and
      the traced window on the host clock);
      one bf16 step of each, kernels against plain from identical weights,
      at 5x the f32 tolerance (25x for ``d4_loss``); the bf16 eval step
      (f32 logits); ``cli.train_mscmrseg.main`` at its default dtype
      (bfloat16) and pipeline (heavy) as phase (i) runs it, its resumed
      epoch 3 bit-equal to an uninterrupted run's; both evaluate CLIs with
      ``-dtype bfloat16`` on phase (j)'s patients (phase (i)'s and (g)'s
      generators and the untrained one: seconds per patient, the share of
      label voxels that differ from phase (j)'s float32 labels), and the
      bf16-trained generator evaluated in float32 and in bfloat16; no
      kernel launched while evaluating;
  (l) data parallelism: two ranks share the card over gloo (NCCL refuses
      two ranks on one device), started with ``torch.multiprocessing``
      (``parallel.launch.spawn``), each with 8 rows of the global batch of
      16, against one process on the whole batch from the same weights
      (cuDNN deterministic): MS-CMRSeg D1+D2+D4 at 224^2 in float32 and in
      bfloat16, and the MM-WHS path (raw batch -> device preprocess with
      light augmentation and FPS clouds -> softmax D2+D4 step, 256^2) in
      float32, two steps each: every metric, the generator's, D1's and
      D2's parameters and BatchNorm buffers after two steps and D4 after
      one (the tolerances by ``DP_UPDATE``), the FPS clouds of each rank
      bit-equal to the one process's rows, each rank's kernel launches a
      step equal to the one process's (``by_path.data_parallel``), the
      ranks' step time, peak memory and all-reduces a step beside the one
      process's, one more step of each profiled; then
      ``cli.train_mscmrseg.main -dist`` with the launcher's environment of a
      world of one (one NCCL rank) against the same command without
      ``-dist``: logged records and checkpoints equal bit for bit.
  (m) the host augmentation route: one heavy host batch (16 x 256^2 x 3
      uint8) made twice from one seed, equal bit for bit; the reference's
      MS-CMRSeg command with ``-host_aug`` at the CLI's defaults (bfloat16,
      heavy) on phase (i)'s fabricated dataset, and MM-WHS with host cloud
      regeneration (``build_mmwhs_pipelines(cfg, host_cloud_regen=True)``,
      ``UDATrainer(device_augment=False)``; light, softmax, D2+D4, float32)
      on phase (g)'s, 2 epochs of 4 steps each at bs 16 through
      ``_cli_training_run`` without its resume (the loader's numpy
      generator is not in the snapshot): launches derived from steps,
      cadence and validation batches, FPS 0 (``by_path.host_augment``,
      ``by_path.host_cloud_regen``), scalars finite, checkpoints present,
      every regenerated cloud of the epochs' first batches on its warped
      mask's boundary voxels and a 50-pixel mask's cloud zero; ms per
      iteration and waiting for batches beside the device route's (phases
      (i) and (k)), the host-regeneration iteration beside the one with
      numpy clouds, ms per host cloud beside phase (e)'s FPS;
  (n) the reproduction runbooks from raw data, every stage of each, through
      ``prep/runbook.py:drive``: MS-CMRSeg (``prep/reproduce.py``) on
      fabricated NIfTI patients (int16, 256^2 x 12 and one 480^2 x 12 for the
      nearest resize, labels {0, 200, 500, 600} with ``lge_test_gt``) ->
      PNGs, datalists, clouds, ``_r1``/``_r2`` rotations, the table's
      ``-aug2 -d1 -d2 -d4`` row (bfloat16, nf 32, 224^2, bs 16) and the
      evaluation with ``-klc``; MM-WHS (``prep/reproduce_mmwhs.py`` main) on
      fabricated TFRecords of 256 x 256 x 3 float32 and phase (g)'s CT
      volumes -> npy, clouds, the paper's command with ``-aug light`` (FPS on
      the card) and its final evaluation, then the evaluate stage. Only
      ``-ns`` and ``-e`` are cut (2 epochs of 4 steps). Every stage's
      artifacts exist; each train stage's launches equal what steps, cadence
      and validation batches give (``by_path.reproduce_mscmrseg``,
      ``by_path.reproduce_mmwhs``) and the evaluate stages launch none;
      per-patient metrics finite (or -1); 64 of the made masks' clouds from
      the host library bit-equal to the numpy plain versions, ms a cloud of
      each; seconds per stage.
  (o) the convergence smokes at full width, through their ``main``:
      ``smoke/smoke_train.py`` at its defaults (80 steps, bs 16, 224^2, nf
      32, bfloat16; Dice >= 0.85 at the last step) and ``smoke/smoke_uda.py
      --d4`` (150 steps, D1+D2+D4, a pool of 12; every metric finite,
      source Dice >= 0.5 at the last step): the Dice trajectory and the
      probes, seconds and slices a second; each run's launches equal what
      its steps, probes and the generator's BatchNorms give
      (``by_path.smoke_train``, ``by_path.smoke_uda``), FPS and the
      one-direction search 0. The quality gates
      (``smoke/quality_gates.py``) are not run here: on the card they fail
      at the JAX gates' seeds from the port's initial weights, as JAX's own
      trajectories fail them on other seeds or on permuted batches (PERF.md
      §6); ``python -m pointcloududa_torch.smoke.quality_gates`` runs them.

Every check raises on failure, so any failure exits non-zero. The line
before the last is the kernel table as JSON (each kernel's time beside its
plain version's, the least time the card could take for the same bytes and
operations, and a library call's time where one computes the same function;
``by_path`` holds each path's launches (``evaluation``, ``evaluation_bf16``: 0
for every kernel)
and, where a kernel's shapes differ
between the paths, its numbers at that path's largest shape). A replayed
CUDA graph calls no kernel wrapper: a path whose train steps replay counts
each replay's launches as its capture recorded them, with a torch.profiler
trace of the card as witness (``_CardLaunches``); the
last line is
``{"ok": true, "device": {...}}``. There is no CPU fallback: without a CUDA
device the script exits non-zero and prints no result.

TF32 is switched off for convolutions and matrix products, so float32 means
float32 on both sides of every comparison. Phases (c) to (j) run in float32,
named explicitly (``compute_dtype="float32"``, ``-dtype float32``: the
training CLIs default to bfloat16), so their numbers compare with earlier
runs of this script; phase (k) runs bfloat16, phase (l) both.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the first runs eagerly, the second captures the step's CUDA graphs and replays them, the last two replay them
STEPS = 4
MMWHS_STEPS = 4
# the training run of phase (g): -bs, -ns, -vert_t_every and the slices per split
RUN_BS, RUN_NS, RUN_VERT_T_EVERY = 16, 64, 2
RUN_SLICES = {"mr_train": 32, "ct_train": 32, "mr_val": 16, "ct_val": 16}
# published peaks of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and
# float32 FLOP/s outside the tensor cores; the kernels' bounds are reckoned
# against them
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Issued instructions a second: 132 SMs x 128 lanes x 1.98 GHz (the boost
# clock). Most of a Chamfer forward's pair is compares, selects and a clamp,
# one issued instruction each, so their bounds count the instructions a pair
# needs, with FMA allowed: one direction's search (nn_kernel) is 7 (3 FFMA
# on (-2c, |c|^2) with |a|^2 added once a query and the clamp moved to
# -|a|^2, a compare and two selects for the running minimum); the fused
# forward needs the distance once (3 FFMA and the other norm's FADD), the
# clamp, and a compare and two selects in either direction: 11. The kernels
# issue more (no FMA, so that their minima are the plain version's bits;
# phase (a) prints what nn_kernel's SASS issues, ``cuobjdump -sass``). The
# figure at the FMA peak stays beside them (``fma_peak_ms``).
INSTR_PER_S = 132 * 128 * 1.98e9
NN_PAIR_INSTRUCTIONS = 7
FUSED_PAIR_INSTRUCTIONS = 11
L2_BYTES = 50e6
# Assumed least cost of one FPS round, whatever the design: the round's point
# is known only after a reduction over the whole cloud (within a block, then
# across the blocks that share the cloud: two barriers and their hand-overs,
# ~1 us at the card's clock), and only then can the next round's pass over
# the distances start. Rounds cannot overlap, so k-1 of them is a floor that
# bytes and operations over the whole card do not see.
FPS_ROUND_FLOOR_US = 1.0
# the CT test volumes of phase (g)'s final evaluation (and of phase (j)): the
# reference's four patients, 256 x 256 x CT_TEST_Z
CT_TEST, CT_TEST_Z = (1003, 1008, 1014, 1019), 32
# phase (j): the LGE test patients and their ground truth's (X, Y, Z) as the
# nii stores it. 6 enlarges from the 256^2 canvas, 7 shrinks by factors that
# are not integers (256/208, 256/240) and is not square
LGE_TEST = {6: (480, 480, 12), 7: (208, 240, 10)}
# card against CPU in phase (j): the share of a patient's label voxels that may
# differ (a last-bit difference between cuDNN's and the CPU's f32 convolutions
# flips the argmax of a near-tie) and the logits' largest difference, scaled by
# their largest magnitude
LABEL_SHARE = 1e-3
LOGIT_SCALED_TOL = 1e-4
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
    # the BN-statistics kernels' bfloat16 instantiations (compute_dtype="bfloat16")
    "bn_stats_forward_bf16": dict(
        route="cuda", source="pointcloududa_torch/csrc/bn_stats.cu",
        replaces="pointcloududa_tpu/ops/bn_pallas.py:96",
    ),
    "bn_stats_backward_bf16": dict(
        route="cuda", source="pointcloududa_torch/csrc/bn_stats.cu",
        replaces="pointcloududa_tpu/ops/bn_pallas.py:123",
    ),
}
BF16_ROWS = {"bn_stats_forward_bf16", "bn_stats_backward_bf16"}


def _bound(nbytes: float, flops: float, chain_ms: float = 0.0, instructions: float | None = None) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input read once, each output written once) over the HBM peak, its
    operations over the float32 peak (or, given ``instructions``, those over
    INSTR_PER_S, with the FMA-peak figure beside as ``fma_peak_ms``), or
    ``chain_ms``, the time of operations that must follow one another,
    whichever is largest. ``bound_by`` names a chain as "operations" (it is
    the operations' dependence, not their number, that binds) and
    ``bound_note`` says so."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    extra = {}
    if instructions is not None:
        extra = dict(bound_note="instructions needed (FMA allowed) over 132 SMs x 128 lanes x 1.98 GHz", fma_peak_ms=t_ops)
        t_ops = instructions / INSTR_PER_S * 1e3
    if chain_ms > max(t_bytes, t_ops):
        return dict(bound_ms=chain_ms, bound_by="operations", bound_note="serial chain",
                    bytes_ms=t_bytes, operations_ms=t_ops)
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations", **extra)


def _max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


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
    fwd_err = bwd_err = 0.0
    # B=40: more blocks than one wave of the backward's grid
    for b, n, m in ((16, 300, 300), (2, 2048, 2048), (3, 300, 77), (40, 300, 300)):
        x = torch.tensor(rng.uniform(size=(b, n, 3)), dtype=torch.float32, device=dev)
        y = torch.tensor(rng.uniform(size=(b, m, 3)), dtype=torch.float32, device=dev)
        (m1, i1), (m2, i2) = ck.nn_directional(x, y), ck.nn_directional(y, x)
        (p1, j1), (p2, j2) = ck.nn_directional_plain(x, y), ck.nn_directional_plain(y, x)
        _require(torch.equal(i1, j1) and torch.equal(i2, j2), f"argmin mismatch at B={b} N={n} M={m}")
        _require(torch.equal(m1, p1) and torch.equal(m2, p2), f"nn minima not bit-equal at B={b} N={n} M={m}")
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
        _require(torch.equal(ck.side_grad(x, y, i1, i2, g), dx) and torch.equal(ck.side_grad(y, x, i2, i1, g), dy),
                 "chamfer backward not bit-reproducible")
        # the autograd path takes the TPU package's route and returns the same gradient
        xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
        before = ck.forward_fused.launches, ck.nn_directional.launches
        ck.chamfer_loss(xg, yg).backward()
        route = (1, 0) if ck.fused_route(n, m) else (0, 2)
        _require((ck.forward_fused.launches - before[0], ck.nn_directional.launches - before[1]) == route,
                 f"chamfer_loss at N={n} M={m} must make {route[0]} fused and {route[1]} one-direction launches")
        _require(torch.equal(xg.grad, dx) and torch.equal(yg.grad, dy), "autograd gradient differs")
        print(f"  chamfer B={b} N={n} M={m}: loss {float(loss):.7f} (plain {float(ref):.7f}) on the "
              f"{'fused' if route[0] else 'large-cloud'} route, argmins equal (one-launch forward and one-direction "
              f"search), minima bit-equal, max|dparts| {err_parts:.3g}, max|dgrad| {err_grad:.3g}, repeat run bit-equal")
        if n > 512:
            print(f"  chamfer_backward B={b} N=M={n}: kernel {graph_ms(lambda: ck.side_grad(x, y, i1, i2, g)):.4f} ms with "
                  f"{ck.backward_lanes(b, n, dev)} threads a point, plain {graph_ms(lambda: ck.side_grad_plain(x, y, i1, i2, g)):.4f} ms, on {card}")
    # duplicated points: every point appears twice; ties go to the lowest index
    base = torch.tensor(rng.uniform(size=(2, 100, 3)), dtype=torch.float32, device=dev)
    dup = torch.cat([base, base], dim=1).contiguous()
    _, idx = ck.nn_directional(dup, dup)
    _, idx_p = ck.nn_directional_plain(dup, dup)
    _, f1, f2 = ck.forward_fused(dup, dup)
    want = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    _require(all(torch.equal(got, want) for got in (idx, idx_p, f1, f2)), "duplicate points: ties not lowest-index")
    # the backward there: points 0..99 are each chosen by two partners, points 100..199 by none (their sum is 0)
    g = torch.tensor(1.0, device=dev)
    err_dup = _max_err(ck.side_grad(dup, dup, f1, f2, g), ck.side_grad_plain(dup, dup, f1, f2, g))
    # one point chosen by every partner: a's point 0 sits among c's points, the rest of a far away
    lone = torch.tensor(rng.uniform(size=(2, 300, 3)), dtype=torch.float32, device=dev) + 10.0
    lone[:, 0] = 0.5
    crowd = torch.tensor(rng.uniform(size=(2, 77, 3)), dtype=torch.float32, device=dev)
    _, l1, l2 = ck.forward_fused(lone, crowd)
    _require(not bool(l2.any()), "every partner must choose point 0")
    err_lone = max(_max_err(ck.side_grad(lone, crowd, l1, l2, g), ck.side_grad_plain(lone, crowd, l1, l2, g)),
                   _max_err(ck.side_grad(crowd, lone, l2, l1, g), ck.side_grad_plain(crowd, lone, l2, l1, g)))
    _require(max(err_dup, err_lone) <= 1e-6, f"chamfer backward differs by {err_dup} (duplicated points), {err_lone} (one point chosen by all)")
    bwd_err = max(bwd_err, err_dup, err_lone)
    print(f"  chamfer duplicated points: argmins are the lowest index (both kernels and plain); backward max|dgrad| {err_dup:.3g}; "
          f"one point chosen by all 77 partners: max|dgrad| {err_lone:.3g}")

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
        large_route_ms=graph_ms(lambda: ck._large_forward_loss(x, y)),
        one_direction_ms=graph_ms(lambda: ck.nn_directional(x, y)),
        launch_floor_ms=floor_ms,
        cluster=native.cluster_size(b, dev),
        **_bound(b * (n + m) * 12 + b * (n + m) * 4 + b * 8, b * n * m * 11, instructions=b * n * m * FUSED_PAIR_INSTRUCTIONS),
    )
    # backward, one cloud: both clouds, both argmin lists and g in, the
    # gradient out; per point of either cloud one unit vector (~12 operations)
    rec["chamfer_backward"].update(
        max_abs_err=bwd_err,
        ms=graph_ms(lambda: ck.side_grad(x, y, i1, i2, g)),
        plain_ms=graph_ms(lambda: ck.side_grad_plain(x, y, i1, i2, g)),
        library_ms=None,
        launch_floor_ms=floor_ms,
        lanes=ck.backward_lanes(b, n, dev),
        # the same launch with 1, 2, 4, 8, 16, 32 threads a point: the wrapper's rule rests on this row
        by_lanes_ms=[graph_ms(lambda: ck._launch_side_grad(x, y, i1, i2, g, lanes=lanes)) for lanes in (1, 2, 4, 8, 16, 32)],
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
    print(f"  chamfer_forward B=16 N=M=300: one launch {r['ms']:.4f} ms in clusters of {r['cluster']} blocks; the large-cloud "
          f"route (two one-direction launches of {r['one_direction_ms']:.4f} ms and five PyTorch launches) "
          f"{r['large_route_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms; bound {r['bound_ms']:.6f} ms by {r['bound_by']} "
          f"({r['bound_note']}; at the FMA peak {r['fma_peak_ms']:.6f}; an empty launch costs {floor_ms:.5f} ms), on {card}")
    r = rec["chamfer_backward"]
    print(f"  chamfer_backward B=16 N=M=300 with 1, 2, 4, 8, 16, 32 threads a point: "
          + ", ".join(f"{t:.4f}" for t in r["by_lanes_ms"]) + f" ms (the wrapper takes {r['lanes']}), on {card}")
    print(f"  chamfer_backward B=16 N=M=300: kernel {r['ms']:.4f} ms with {r['lanes']} threads a point, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms by {r['bound_by']} (an empty launch costs {floor_ms:.5f} ms), repeat runs bit-equal, on {card}")
    phase_nn(torch, dev, rec, card)


# the one-direction search's shapes in phase (a): the first three are timed
# (the row of the kernels line is the first); (2, 600, 530) is the CPU
# tests' large-route shape, (16, 300, 300) the training clouds' size
NN_SHAPES = ((2, 2048, 2048), (16, 2048, 2048), (1, 8192, 8192), (2, 600, 530), (16, 300, 300), (3, 257, 40), (1, 1, 5))
NN_TIMED = 3


def _nn_clouds(torch, rng, dev, b, n, m, grid: bool):
    """Uniform clouds in [0, 1)^3, or the same snapped to a grid of 1/8,
    where many distances tie exactly."""
    def one(k):
        u = rng.uniform(size=(b, k, 3))
        return torch.tensor(np.round(u * 8) / 8 if grid else u, dtype=torch.float32, device=dev)
    return one(n), one(m)


# the opcodes of a pair's own arithmetic in nn_kernel's walk (the rest is
# the loop's: loads, index and address arithmetic, the branch)
PAIR_OPCODES = ("FMUL", "FADD", "FMNMX", "FSETP", "SEL")


def _walk_sass(sass: str, marker: str, pairs: int) -> dict:
    """Instructions of a kernel's innermost loop that holds ``pairs`` x 3
    FMULs (``nn_kernel``'s unrolled walk: 4 partners x 4 queries), from
    ``cuobjdump -sass`` output: those a pair issues in all, and those of the
    pair's own arithmetic (PAIR_OPCODES)."""
    body = next(f for f in sass.split("Function : ")[1:] if marker in f.split("\n", 1)[0])
    code = [(int(a, 16), ins.split()) for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    ops = [(a, words[1] if words[0].startswith("@") else words[0], words[-1]) for a, words in code]
    loops = []
    for addr, op, target in ops:
        if op == "BRA" and target.startswith("0x") and int(target, 16) < addr:
            loop = [o.split(".")[0] for a, o, _ in ops if int(target, 16) <= a <= addr]
            if loop.count("FMUL") == 3 * pairs and "FSETP" in loop:  # not the staging loop
                loops.append(loop)
    loop = min(loops, key=len)
    return dict(per_pair=len(loop) / pairs, own_per_pair=sum(loop.count(o) for o in PAIR_OPCODES) / pairs,
                by_opcode={o: loop.count(o) / pairs for o in PAIR_OPCODES})


def phase_nn(torch, dev, rec, card):
    """(a), continued: the one-direction search (``nn_kernel``) against its
    plain version at NN_SHAPES and in every launch plan, timed by plan; then
    the large-cloud path's launches."""
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops.losses import chamfer_loss as plain_chamfer
    from pointcloududa_torch.utils import native
    from pointcloududa_torch.utils.timing import graph_ms

    rng = np.random.default_rng(9)
    sms = native.sm_count(dev)
    nn_err = 0.0
    for b, n, m in NN_SHAPES:
        for grid in (False, True):
            x, y = _nn_clouds(torch, rng, dev, b, n, m, grid)
            mins, idx = ck.nn_directional(x, y)
            again = ck.nn_directional(x, y)
            want_mins, want_idx = ck.nn_directional_plain(x, y)
            nn_err = max(nn_err, _max_err(mins, want_mins))
            _require(torch.equal(idx, want_idx), f"nn argmins differ at {(b, n, m)} (grid {grid})")
            _require(torch.equal(mins, want_mins), f"nn minima not bit-equal at {(b, n, m)} (grid {grid})")
            _require(torch.equal(again[0], mins) and torch.equal(again[1], idx), f"nn not bit-reproducible at {(b, n, m)}")
        print(f"  chamfer_nn_forward {(b, n, m)}: {ck.nn_plan(b, n, m, sms)}; argmins equal, minima bit-equal, "
              f"repeat bit-equal (uniform and grid clouds)")
    # every plan the kernel takes, on a tie-heavy cloud and on duplicated points (ties at the lowest index)
    x, y = _nn_clouds(torch, rng, dev, 2, 600, 530, grid=True)
    want_mins, want_idx = ck.nn_directional_plain(x, y)
    base = torch.tensor(rng.uniform(size=(2, 100, 3)), dtype=torch.float32, device=dev)
    dup = torch.cat([base, base], dim=1).contiguous()
    want_dup = (torch.arange(200, device=dev) % 100).to(torch.int32).expand(2, -1)
    plans = 0
    for lanes in (1, 2, 4, 8, 16, 32):
        for size in range(1, native.MAX_CLUSTER + 1):
            mins, idx = ck._launch_nn(x, y, ck.nn_plan(2, 600, 530, sms, lanes=lanes, cluster=size))
            _, idx_dup = ck._launch_nn(dup, dup, ck.nn_plan(2, 200, 200, sms, lanes=lanes, cluster=size))
            _require(torch.equal(idx, want_idx) and torch.equal(mins, want_mins) and torch.equal(idx_dup, want_dup),
                     f"nn kernel differs from plain with lanes={lanes} cluster={size}")
            plans += 1
    before = ck.nn_directional.launches
    try:
        ck._launch_nn(x, y, ck.nn_plan(2, 600, 530, sms)._replace(cluster=9))
    except RuntimeError:
        pass
    else:
        raise AssertionError("a cluster of 9 must be refused")
    _require(ck.nn_directional.launches == before, "a refused launch was counted")
    print(f"  chamfer_nn_forward: all {plans} plans (lanes 1..32 x clusters 1..8) equal the plain version "
          f"on a grid cloud (2, 600, 530) and on duplicated points (lowest index); a cluster of 9 is refused")

    r = rec["chamfer_nn_forward"]
    r.update(max_abs_err=nn_err, library_ms=None, by_shape={})
    cuobjdump = os.path.join(os.path.dirname(native._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", native.library_path()], capture_output=True, text=True,
                          check=True).stdout if os.path.isfile(cuobjdump) else None
    for b, n, m in NN_SHAPES[:NN_TIMED]:
        x, y = _nn_clouds(torch, rng, dev, b, n, m, grid=False)
        plan = ck.nn_plan(b, n, m, sms)
        row = dict(
            plan=plan._asdict(),
            ms=graph_ms(lambda: ck.nn_directional(x, y)),
            plain_ms=graph_ms(lambda: ck.nn_directional_plain(x, y)),
            # both clouds in, the minima and argmins out; per pair the NN_PAIR_INSTRUCTIONS it needs with FMA
            # (9 operations at the FMA peak, as before: 3 products, 2 sums, a sum, a product, a difference, a clamp)
            **_bound(b * (n + m) * 12 + b * n * 8, b * n * m * 9, instructions=b * n * m * NN_PAIR_INSTRUCTIONS),
            cdist_min_ms=graph_ms(lambda: torch.cdist(x, y).min(-1)),
            fused_route_ms=graph_ms(lambda: ck._fused_forward_loss(x, y)),
            large_route_ms=graph_ms(lambda: ck._large_forward_loss(x, y)),
            by_cluster_ms={s: graph_ms(lambda: ck._launch_nn(x, y, ck.nn_plan(b, n, m, sms, lanes=plan.lanes, cluster=s)))
                           for s in (1, 2, 4, 8)},
            by_lanes_ms={l: graph_ms(lambda: ck._launch_nn(x, y, ck.nn_plan(b, n, m, sms, lanes=l, cluster=plan.cluster)))
                         for l in (1, 2, 4, 8, 16, 32)},
        )
        if sass is not None:  # what the plan's instantiation issues a pair in its walk
            row["sass"] = _walk_sass(sass, f"nn_kernelILi{plan.lanes}EE", 4 * ck.NN_QUERIES)
            print(f"  nn_kernel<{plan.lanes}> in its SASS: {row['sass']['per_pair']:.3f} instructions "
                  f"issued a pair in the walk, {row['sass']['own_per_pair']:.3f} of them the pair's own "
                  f"({row['sass']['by_opcode']}); the bound counts the {NN_PAIR_INSTRUCTIONS} the function needs with FMA")
        r["by_shape"][f"{b}x{n}x{m}"] = row
        route = "fused" if ck.fused_route(n, m) else "large-cloud"
        print(f"  chamfer_nn_forward {(b, n, m)}: kernel {row['ms']:.5f} ms ({plan}), plain {row['plain_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.5f} ms by {row['bound_by']} ({row['bound_note']}; at the FMA peak "
              f"{row['fma_peak_ms']:.5f}), {row['bound_ms'] / row['ms']:.0%} of it; torch.cdist + min (two calls, "
              f"never used by the port) {row['cdist_min_ms']:.4f} ms; the whole forward: fused route "
              f"{row['fused_route_ms']:.4f} ms, large-cloud route {row['large_route_ms']:.4f} ms (the loss takes the "
              f"{route} route), on {card}")
        print(f"    by plan: clusters 1, 2, 4, 8 at {plan.lanes} lanes: "
              + ", ".join(f"{t:.5f}" for t in row["by_cluster_ms"].values())
              + f"; lanes 1..32 in clusters of {plan.cluster}: " + ", ".join(f"{t:.5f}" for t in row["by_lanes_ms"].values())
              + " ms")
    r.update({k: v for k, v in r["by_shape"][f"{NN_SHAPES[0][0]}x{NN_SHAPES[0][1]}x{NN_SHAPES[0][2]}"].items()},
             shape=list(NN_SHAPES[0]))

    # the large-cloud path: the loss and its gradient above 512 x 512 pairs, launches counted from 0
    b, n, m = NN_SHAPES[0]
    x, y = _nn_clouds(torch, rng, dev, b, n, m, grid=False)
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    _reset_launches()
    loss = ck.chamfer_loss(xg, yg)
    loss.backward()
    torch.cuda.synchronize()
    counts = _launch_counts()
    loss = loss.detach()
    want = {name: 0 for name in counts} | {"chamfer_nn_forward": 2, "chamfer_backward": 2}
    _require(counts == want, f"launches of chamfer_loss(x, y).backward() at {(b, n, m)}: {counts}, want {want}")
    _record_launches(rec, "chamfer_large", counts, {"chamfer_nn_forward", "chamfer_backward"})
    ref = plain_chamfer(x, y)
    _require(abs(float(loss) - float(ref)) <= 1e-5 * abs(float(ref)), f"large-cloud loss {float(loss)} vs {float(ref)}")
    (_, j1), (_, j2) = ck.nn_directional_plain(x, y), ck.nn_directional_plain(y, x)
    g = torch.tensor(1.0, device=dev)
    err_grad = max(_max_err(xg.grad, ck.side_grad_plain(x, y, j1, j2, g)), _max_err(yg.grad, ck.side_grad_plain(y, x, j2, j1, g)))
    _require(err_grad <= 1e-6, f"large-cloud gradients differ by {err_grad}")
    print(f"  by_path.chamfer_large: chamfer_loss(x, y).backward() at {(b, n, m)}: launches {counts}; loss {float(loss):.7f} "
          f"(plain {float(ref):.7f}), max|dgrad| {err_grad:.3g}")


# every BatchNorm input of the generator at bs 16, by path: 224^2 for MS-CMRSeg,
# 256^2 for MM-WHS (encoder and decoder levels share the shapes; the 512-channel
# bottleneck has no BatchNorm). Phases (c) and (f) fail if a step's BatchNorm
# inputs are not exactly these.
BN_SHAPES = {
    "mscmrseg": ((16, 32, 224, 224), (16, 64, 112, 112), (16, 128, 56, 56), (16, 256, 28, 28)),
    "mmwhs": ((16, 32, 256, 256), (16, 64, 128, 128), (16, 128, 64, 64), (16, 256, 32, 32)),
}


def _bf16_ulps(torch, got, want) -> float:
    """The largest |got - want| of two bf16 tensors in bf16 ulps at ``want``."""
    want = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-126))) - 7)
    return float(((got.float() - want).abs() / ulp).max())


def _kernel_names(torch, fn) -> list:
    """Names of the CUDA kernels in one profiler trace of ``fn``, in the
    order they start. On the H100 a trace can lose kernels (7 of 40 traces
    of the same 32 calls held fewer, some none), never gain any: a caller
    that needs every kernel takes traces until one is complete."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return [e.name for e in sorted(kernels, key=lambda e: e.time_range.start)]


def phase_bn(torch, dev, rec):
    """(b) BN-statistics kernels against their plain versions, on the shapes
    of both paths, for a float32 and a bfloat16 activation (the bf16
    instantiation reads 2 bytes an element and widens in registers; its
    statistics are f32, its dx bf16); each call one CUDA kernel; the launch
    plan at each shape, the forward's cluster size and the backward's grid
    against alternatives at the 32-channel bf16 shapes, and the card's
    clusters at once for the plan."""
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.utils.timing import graph_ms

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        fwd_name, bwd_name = "bn_stats_forward" + suffix, "bn_stats_backward" + suffix
        size = torch.finfo(dtype).bits // 8
        for path, shapes in BN_SHAPES.items():
            fwd_err = bwd_err = 0.0
            for shape in shapes:
                x = (torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2).to(dtype)
                outer, c, inner = bk._layout(x)
                n = outer * inner
                mk, qk = bk.stats_forward(x)
                mp, qp = bk.stats_forward_plain(x)
                # f32 sums over up to 1,048,576 values in another order than PyTorch's
                for got, want in ((mk, mp), (qk, qp)):
                    err = _max_err(got, want)
                    _require(got.dtype == torch.float32 and err <= 1e-5 + 1e-5 * float(want.abs().max()),
                             f"BN stats ({dtype}) differ by {err} at {shape}")
                    fwd_err = max(fwd_err, err)
                mk2, qk2 = bk.stats_forward(x)
                _require(torch.equal(mk, mk2) and torch.equal(qk, qk2), f"BN stats ({dtype}) not bit-reproducible")
                gm = torch.randn(c, generator=gen, device=dev)
                gq = torch.randn(c, generator=gen, device=dev)
                dk = bk.stats_backward(x, gm, gq)
                dp = bk.stats_backward_plain(x, gm, gq)
                err = _max_err(dk, dp)
                if dtype == torch.float32:
                    _require(err <= 1e-6 * (1.0 + float(dp.abs().max())), f"BN backward differs by {err} at {shape}")
                else:  # both compute dx in f32 and round it once to bf16
                    ulps = _bf16_ulps(torch, dk, dp)
                    _require(dk.dtype == torch.bfloat16 and ulps <= 1.0, f"BN backward (bf16) {ulps} ulps from plain at {shape}")
                _require(torch.equal(dk, bk.stats_backward(x, gm, gq)), f"BN backward ({dtype}) not bit-reproducible")
                bwd_err = max(bwd_err, err)
                fplan = bk.forward_plan(outer, c, inner, dtype, bk._aligned(x), sms)
                bplan = bk.backward_plan(outer, c, inner, dtype, bk._aligned(x, dk))
                at_once = bk.forward_clusters(dtype, fplan.vec, fplan.cluster, dev)
                # the two per-channel vectors of the backward's library call, made outside the timed call
                a = (gm * (1.0 / n)).view(1, c, 1, 1)
                b = (gq * (2.0 / n)).view(1, c, 1, 1)
                dl = torch.empty_like(x)
                # forward: x in, 2 C floats out, 3 operations per element; backward:
                # x and 2 C floats in, dx out, 3 operations per element
                fwd = dict(
                    shape=list(shape), dtype=str(dtype).split(".")[1], ms=graph_ms(lambda: bk.stats_forward(x)),
                    plain_ms=graph_ms(lambda: bk.stats_forward_plain(x)),
                    # the one PyTorch call that computes the forward's function; a
                    # yardstick only, the port never calls it (of a bf16 x it
                    # returns bf16 statistics: rounded, where the kernel's are f32)
                    library_ms=graph_ms(lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0)),
                    cluster=fplan.cluster, vec=fplan.vec, clusters_at_once=at_once,
                    **_bound(x.numel() * size + 2 * c * 4, 3 * x.numel()),
                )
                bwd = dict(
                    shape=list(shape), dtype=fwd["dtype"], ms=graph_ms(lambda: bk.stats_backward(x, gm, gq)),
                    plain_ms=graph_ms(lambda: bk.stats_backward_plain(x, gm, gq)),
                    # one PyTorch call computing dx = a + x * b in f32, rounded once
                    # into dx's type (a yardstick only, never called by the port)
                    library_ms=graph_ms(lambda: torch.addcmul(a, x, b, out=dl)),
                    vec=bplan.vec, blocks=bplan.blocks,
                    **_bound(2 * x.numel() * size + 2 * c * 4, 3 * x.numel()),
                )
                if dtype == torch.bfloat16 and c == 32:  # the plans against their alternatives
                    fwd["by_cluster_ms"] = [
                        graph_ms(lambda: bk._launch_forward(x, bk.forward_plan(outer, c, inner, dtype, True, cluster=s)))
                        for s in (1, 2, 4, 8)]
                    # the backward in one wave of 4 blocks an SM, each thread taking several rounds
                    bwd["one_wave_ms"] = graph_ms(lambda: bk._launch_backward(x, gm, gq, dl, bplan._replace(blocks=4 * sms)))
                # what a call moves, against the 50 MB L2 that keeps it across graph_ms's 20 calls
                l2 = {k: " (L2-resident)" if m * x.numel() * size <= L2_BYTES else "" for k, m in (("fwd", 1), ("bwd", 2))}
                print(f"  bn_stats {fwd['dtype']} {path} {shape}: fwd kernel {fwd['ms']:.4f} ms (plain {fwd['plain_ms']:.4f}, "
                      f"torch.var_mean {fwd['library_ms']:.4f}, bound {fwd['bound_ms']:.4f}: {fwd['bound_ms'] / fwd['ms']:.0%} "
                      f"of bound{l2['fwd']}, {fwd['library_ms'] / fwd['ms']:.2f}x ahead of the library), bwd kernel "
                      f"{bwd['ms']:.4f} ms (plain {bwd['plain_ms']:.4f}, torch.addcmul {bwd['library_ms']:.4f}, bound "
                      f"{bwd['bound_ms']:.4f}: {bwd['bound_ms'] / bwd['ms']:.0%} of bound{l2['bwd']}, "
                      f"{bwd['library_ms'] / bwd['ms']:.2f}x ahead of the library)")
                print(f"    plan: forward clusters of {fplan.cluster} ({c * fplan.cluster} blocks; {at_once} such clusters "
                      f"at once on the card, {c} needed for one wave), {fplan.vec} values a load, {fplan.chunk} loads a "
                      f"block; backward {bplan.blocks} blocks, {bplan.vec} values a load")
                if "by_cluster_ms" in fwd:
                    print(f"    forward in clusters of 1, 2, 4, 8: " + ", ".join(f"{t:.4f}" for t in fwd["by_cluster_ms"])
                          + f" ms (the plan takes {fplan.cluster}); backward in one wave of {4 * sms} blocks "
                          f"{bwd['one_wave_ms']:.4f} ms against the plan's {bplan.blocks} blocks {bwd['ms']:.4f} ms")
                if shape == shapes[0]:  # the kernel table carries each path's largest shape
                    rec[fwd_name].setdefault("by_path", {})[path + suffix] = fwd
                    rec[bwd_name].setdefault("by_path", {})[path + suffix] = bwd
                del x, dk, dp, dl
            rec[fwd_name]["by_path"][path + suffix]["max_abs_err"] = fwd_err
            rec[bwd_name]["by_path"][path + suffix]["max_abs_err"] = bwd_err
            print(f"  bn_stats {dtype} {path} max|err| over its four shapes: fwd {fwd_err:.3g}, bwd {bwd_err:.3g}")
        # the top-level numbers of a row: the largest shape of all, the error over both paths
        for name in (fwd_name, bwd_name):
            by_path = rec[name]["by_path"]
            rec[name].update(by_path["mmwhs" + suffix], max_abs_err=max(by_path[p + suffix]["max_abs_err"] for p in BN_SHAPES))
    # one CUDA kernel a call: traces over a forward and a backward call at every shape in both dtypes, until
    # one holds exactly the calls' kernels in order (at most 10; see _kernel_names)
    inputs = [((torch.randn(shape, generator=gen, device=dev) * 0.7 + 0.2).to(dtype),
               torch.randn(shape[1], generator=gen, device=dev))
              for dtype in (torch.float32, torch.bfloat16) for shapes in BN_SHAPES.values() for shape in shapes]
    want = ["stats_forward_kernel", "stats_backward_kernel"] * len(inputs)

    def complete(names):
        return len(names) == len(want) and all(w in n for w, n in zip(want, names))

    counts, names = [], []
    while len(counts) < 10 and not complete(names):
        names = _kernel_names(torch, lambda: [(bk.stats_forward(x), bk.stats_backward(x, g, g)) for x, g in inputs])
        counts.append(len(names))
    _require(complete(names), f"{len(inputs)} forward and backward calls: no trace of {counts} kernels holds one "
             f"forward and one backward kernel a call; the last: {names}")
    print(f"  one CUDA kernel a call: the trace of a forward and a backward call at each of the {len(inputs)} shapes and "
          f"dtypes holds {len(names)} kernels, a forward and a backward kernel in turn (trace {len(counts)}; kernels "
          f"in each: {counts})")
    del inputs
    print("  note: graph_ms replays 20 captured calls back to back; where a call moves at most the L2's 50 MB (marked "
          "L2-resident) x stays in L2 from call to call, so a share of the HBM bound near or above 100% there is L2's doing")
    half = torch.zeros((4, 8, 6, 6), dtype=torch.float16, device=dev)
    for fn in (lambda: bk.stats_forward(half), lambda: bk.stats_backward(half, half[0, :, 0, 0].float(), half[0, :, 0, 0].float())):
        try:
            fn()
        except ValueError:
            continue
        raise AssertionError("a float16 tensor reached a BN-statistics kernel")
    print("  a float16 activation is refused by both wrappers (ValueError)")


def _launch_counts():
    from pointcloududa_torch.ops import bn_kernel as bk
    from pointcloududa_torch.ops import chamfer_kernel as ck
    from pointcloududa_torch.ops import fps_kernel as fk

    return {
        "chamfer_forward": ck.forward_fused.launches,
        "chamfer_nn_forward": ck.nn_directional.launches,
        "chamfer_backward": ck.side_grad.launches,
        "bn_stats_forward": bk.stats_forward.launches - bk.stats_forward.bf16_launches,
        "bn_stats_backward": bk.stats_backward.launches - bk.stats_backward.bf16_launches,
        "bn_stats_forward_bf16": bk.stats_forward.bf16_launches,
        "bn_stats_backward_bf16": bk.stats_backward.bf16_launches,
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


# the port kernels' names in a trace of the card, and their kernel-table rows (a BN-statistics kernel's bfloat16
# instantiation, whose name holds __nv_bfloat16, takes the _bf16 row)
TRACE_ROWS = {"fused_forward_kernel": "chamfer_forward", "nn_kernel": "chamfer_nn_forward",
              "side_grad_kernel": "chamfer_backward", "stats_forward_kernel": "bn_stats_forward",
              "stats_backward_kernel": "bn_stats_backward", "fps_kernel": "fps"}
TRACE_NAME = re.compile(r"\b(" + "|".join(TRACE_ROWS) + r")\b")
# train steps between two traces of _CardLaunches.every: a trace keeps a bounded number of records
STEPS_A_TRACE = 25


def _trace_row(name: str):
    """The kernel-table row of a kernel named ``name`` in a trace, or None."""
    found = TRACE_NAME.search(name)
    if found is None:
        return None
    row = TRACE_ROWS[found.group(1)]
    return row + "_bf16" if row.startswith("bn_") and "bfloat16" in name else row


class _CardLaunches:
    """``with _CardLaunches(torch) as launched:``: the port kernels' launches
    on the card while the block runs, in ``launched.counts`` by kernel-table
    row (``_launch_counts``'s keys) when it ends, eager launches and those
    replayed from a CUDA graph alike. A replay calls no kernel wrapper: the
    wrappers' counters, reset when the block begins, count the eager calls
    and the calls a capture records, and each step graph
    (``step_graph.CudaGraph``) captured in the block adds what its capture
    recorded at each replay. A torch.profiler trace of the card over the
    block (``traced``) witnesses the launches: it may miss some (in one run
    of this script, 1 of a step's 67 launches in phase (l), 27 of 10,057 in
    ``smoke_uda``'s 150 steps) and never holds more, so it must hold at most
    ``counts`` and miss at most 1% of all (or one launch). ``every()`` makes the train steps that
    ``make_train_step`` makes in the block end a trace and begin the next
    every ``STEPS_A_TRACE`` steps, for a run longer than one trace holds
    (``traces`` counts them)."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = dict.fromkeys(_launch_counts(), 0)
        self.traced = dict(self.counts)
        self.captured, self.replayed = dict(self.counts), dict(self.counts)
        self.traces = 0
        self._prof = None
        self._restore = []

    def __enter__(self):
        from pointcloududa_torch.train import step_graph

        graph = step_graph.CudaGraph
        init, replay = graph.__init__, graph.replay

        def counted_init(g, body, generator, pool=None):
            before = _launch_counts()
            init(g, body, generator, pool)
            g.recorded = {k: n - before[k] for k, n in _launch_counts().items()}
            for k, n in g.recorded.items():
                self.captured[k] += n

        def counted_replay(g):
            out = replay(g)
            for k, n in getattr(g, "recorded", {}).items():  # a graph captured outside the block is not counted
                self.replayed[k] += n
            return out

        graph.__init__, graph.replay = counted_init, counted_replay
        self._restore.append(lambda: (setattr(graph, "__init__", init), setattr(graph, "replay", replay)))
        _reset_launches()
        self._begin()
        return self

    def _begin(self):
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()

    def _end(self):
        self.torch.cuda.synchronize()
        self._prof.stop()
        self.traces += 1
        for e in self._prof.profiler.kineto_results.events():
            row = _trace_row(e.name()) if e.device_type() == self.torch.autograd.DeviceType.CUDA else None
            if row is not None:
                self.traced[row] += 1
        self._prof = None

    def every(self):
        from pointcloududa_torch.train import step as step_module

        make = step_module.make_train_step

        def cutting(*args, **kwargs):
            step, calls = make(*args, **kwargs), [0]

            def cut_step(*a, **kw):
                calls[0] += 1
                if calls[0] % STEPS_A_TRACE == 0:  # between two steps: nothing is in flight
                    self._end()
                    self._begin()
                return step(*a, **kw)

            return cut_step

        step_module.make_train_step = cutting
        self._restore.append(lambda: setattr(step_module, "make_train_step", make))

    def __exit__(self, kind, value, tb):
        for restore in self._restore:
            restore()
        self._end()
        if kind is None:
            called = _launch_counts()
            self.counts = {k: n - self.captured[k] + self.replayed[k] for k, n in called.items()}
            more = {k: (n, self.counts[k]) for k, n in self.traced.items() if n > self.counts[k]}
            _require(not more, f"the trace holds more launches than ran (traced, ran): {more}")
            missed = sum(self.counts.values()) - sum(self.traced.values())
            _require(missed <= max(1, sum(self.counts.values()) // 100),
                     f"the trace misses {missed} launches: traced {self.traced}, ran {self.counts}")
            if missed:
                print(f"  note: the profiler's trace missed {missed} of {sum(self.counts.values())} port-kernel launches "
                      f"(traced {self.traced})")
        return False


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
    from pointcloududa_torch.utils import timer

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

    times, history = [], []
    timer.reset_spans()
    with _CardLaunches(torch) as launched:
        for batch in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, batch)
            end.record()
            history.append(metrics)
            end.synchronize()
            times.append(start.elapsed_time(end))
    counts = launched.counts
    totals = timer.span_totals(profiled=True)  # the steps ran under the trace
    _require(totals[timer.GEN_CAPTURE][1] == totals[timer.DISC_CAPTURE][1] == 1
             and totals[timer.GEN_REPLAY][1] == totals[timer.DISC_REPLAY][1] == STEPS - 1,
             f"step 2 captures both blocks and steps 2-{STEPS} replay them: spans {totals}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    stop_watching()
    _require(bn_seen == set(BN_SHAPES["mscmrseg"]), f"BatchNorm inputs {sorted(bn_seen)} are not phase (b)'s shapes")

    for i, metrics in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not np.isfinite(v)]
        _require(not bad, f"step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(values.items())))
    # the one-direction search serves large clouds only: no path runs it
    _record_launches(rec, "mscmrseg", counts, set(counts) - {"fps", "chamfer_nn_forward"} - BF16_ROWS)
    _require(counts["fps"] == 0, "the MS-CMRSeg step regenerates no clouds")
    _require(not any(counts[k] for k in BF16_ROWS), f"a float32 step launched a bfloat16 kernel: {counts}")
    _require((counts["chamfer_forward"], counts["chamfer_nn_forward"], counts["chamfer_backward"]) == (2 * STEPS, 0, STEPS),
             f"per step the Chamfer loss must launch 2 fused forwards, no one-direction search and 1 backward: {counts}")
    print(f"  launches on the card in {STEPS} steps: {counts}")
    # the first step pays cuDNN's algorithm choice and the allocator's growth, the second the capture
    print(f"  train step (bs 16, 224^2, f32, D1+D2+D4, both kernels, traced): median {statistics.median(times[2:]):.2f} ms "
          f"replayed (steps 3-{STEPS}), the capture's step {times[1]:.2f} ms (all: {', '.join(f'{t:.2f}' for t in times)}), "
          f"peak memory {peak_gib:.2f} GiB, on {card}")
    return cfg, {name: n // STEPS for name, n in counts.items()}


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

    pre_ms, step_ms, history = [], [], []
    with _CardLaunches(torch) as launched:
        for raw in raws:
            batch, t = event_ms(lambda: preprocess(gen, raw))
            pre_ms.append(t)
            (state, metrics), t = event_ms(lambda: step(state, batch))
            step_ms.append(t)
            history.append(metrics)
    counts = launched.counts
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
    _require(not any(counts[k] for k in BF16_ROWS), f"a float32 step launched a bfloat16 kernel: {counts}")
    _record_launches(rec, "mmwhs", counts, set(counts) - {"chamfer_nn_forward"} - BF16_ROWS)
    print(f"  launches on the card in {MMWHS_STEPS} preprocess + step calls: {counts}")
    # the first call pays cuDNN's algorithm choice and the allocator's growth
    print(f"  MM-WHS device preprocess (bs 16, 256^2, light augmentation of both streams + 32 clouds by the FPS "
          f"kernel, traced): median {statistics.median(pre_ms[1:]):.2f} ms over calls 1-{MMWHS_STEPS - 1} "
          f"(all: {', '.join(f'{t:.2f}' for t in pre_ms)}), on {card}")
    # step 1 eager, step 2 the capture
    print(f"  MM-WHS train step (bs 16, 256^2, f32, softmax, D2+D4, all kernels, traced): median "
          f"{statistics.median(step_ms[2:]):.2f} ms replayed (steps 3-{MMWHS_STEPS}) "
          f"(all: {', '.join(f'{t:.2f}' for t in step_ms)}), peak memory {peak_gib:.2f} GiB, on {card}")

    # the same preprocess with the point head off: no clouds, so no FPS launch
    no_clouds = make_device_preprocess(dataclasses.replace(cfg, d4=False), train=True, device_augment=True)
    before = _launch_counts()["fps"]
    bare_ms = [event_ms(lambda: no_clouds(gen, raw))[1] for raw in raws]
    _require(_launch_counts()["fps"] == before, "the point head is off: no cloud may be regenerated")
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
    return statistics.median(pre_ms[1:]), statistics.median(step_ms[1:])


def _fabricate_mmwhs(root: str, seed: int, ct_test: bool = True) -> int:
    """An MM-WHS dataset in the directory contract of ``data/mmwhs.py``:
    float32 256 x 256 x 3 slices (noise around the structures, so that there
    is something to segment), uint8 masks of four filled ellipses, and (300,
    3) vertex files on the 0..255 scale for the streams that load them (the
    validation streams and ``ct_train``, which is also the third validation
    set), the four datalists and, with ``ct_test``, the CT test volumes."""
    from pointcloududa_torch.data.manifest import write_ids
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks

    rng = np.random.default_rng(seed)
    for j, (split, n) in enumerate(RUN_SLICES.items()):
        base = os.path.join(root, "PnpAda_release_data", split)
        for sub in ("img", "mask", "vertices"):
            os.makedirs(os.path.join(base, sub))
        masks = synthetic_blob_masks(n, 256, seed=seed + 1 + j)
        ids = [f"{split}_slice{i}.tfrecords" for i in range(n)]
        for _id, mask in zip(ids, masks):
            img = rng.normal(size=(256, 256, 3)).astype(np.float32) * 0.5 + mask[..., None].astype(np.float32) * 0.5
            np.save(os.path.join(base, "img", f"{_id}.npy"), img)
            np.save(os.path.join(base, "mask", f"{_id}.npy"), mask[..., None])
            if split != "mr_train":
                np.save(os.path.join(base, "vertices", f"{_id}.npy"), (rng.uniform(size=(300, 3)) * 255.0).astype(np.float32))
        write_ids(os.path.join(root, f"{split}_list.csv"), ids)
    return sum(RUN_SLICES.values()) + (_fabricate_ct_test(root, seed) if ct_test else 0)


def _ellipsoids(shape, n_labels: int, rng) -> np.ndarray:
    """(Z, Y, X) uint8 labels 1..n_labels of filled ellipsoids, each over
    the ones before it: connected structures, as anatomy has."""
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    out = np.zeros(shape, np.uint8)
    for label in range(1, n_labels + 1):
        cz, cy, cx = (rng.uniform(0.3 * n, 0.7 * n) for n in shape)
        rz = rng.uniform(0.25 * shape[0], 0.45 * shape[0])
        ry, rx = (rng.uniform(0.08 * n, 0.22 * n) for n in shape[1:])
        out[((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = label
    return out


def _fabricate_ct_test(root: str, seed: int) -> int:
    """The four CT test patients of ``eval/volume.py:read_mmwhs_volume``,
    written by the port's ``save_nii``: 256 x 256 x Z float32 images (noise
    around the structures, as the training slices) and int16 ground truth of
    four ellipsoids labelled 1-4."""
    from pointcloududa_torch.utils.nifti import save_nii

    base = os.path.join(root, "PnpAda_release_data", "test_ct_image_n_labels")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed + 100)
    for pat_id in CT_TEST:
        labels = _ellipsoids((CT_TEST_Z, 256, 256), 4, rng)
        img = rng.normal(size=labels.shape).astype(np.float32) * 0.5 + labels.astype(np.float32) * 0.5
        save_nii(os.path.join(base, f"image_ct_{pat_id}.nii.gz"), np.moveaxis(img, 0, 2))
        save_nii(os.path.join(base, f"gth_ct_{pat_id}.nii.gz"), np.moveaxis(labels.astype(np.int16), 0, 2))
    return len(CT_TEST) * CT_TEST_Z


def _read_scalars(logdir: str) -> dict:
    """{epoch: {scalar: value}} of the ``metrics.jsonl`` files under ``logdir``,
    but the ``timing/`` host milliseconds, which no two runs share."""
    recs: dict = {}
    for folder, _, files in os.walk(logdir):
        if "metrics.jsonl" in files:
            with open(os.path.join(folder, "metrics.jsonl")) as f:
                for line in f:
                    r = json.loads(line)
                    recs.setdefault(r["step"], {}).update(
                        {k: v for k, v in r.items() if k not in ("step", "time") and not k.startswith("timing/")})
    return recs


def _quiet(fn, *args, **kw):
    """Call ``fn`` with its standard output indented under the phase's."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    for line in out.getvalue().splitlines():
        print(f"    | {line}")
    return result, out.getvalue()


@contextlib.contextmanager
def _eval_clock():
    """While it is open, the port's volume evaluations note per patient the
    host seconds of the batched forward (it ends in the copy of the logits to
    the host, so it waits for the card) and of the whole patient (reading,
    forward, CLAHE, resize, KLC, metrics), the host seconds of each of those
    steps over the evaluation, the label volumes handed to the metrics and
    what the metrics returned for them, and each evaluation's returned
    summary."""
    from pointcloududa_torch.eval import volume
    from pointcloududa_torch.ops import metrics

    steps = {"read": ("load_nii", "read_png"), "clahe": ("apply_clahe",), "resize": ("resize_volume",),
             "klc": ("keep_largest_connected_components",)}
    rec = dict(forward=[], total=[], labels=[], scores=[], results=[], mark=time.perf_counter(),
               host=dict.fromkeys([*steps, "metrics"], 0.0))
    saved = {(m, n): getattr(m, n) for m, n in [(volume, "make_volume_forward"), (volume, "evaluate_mscmrseg"),
                                                 (volume, "evaluate_mmwhs"), (metrics, "compute_metrics_on_files"),
                                                 (metrics, "metrics_mmwhs_volume")]
             + [(volume, n) for names in steps.values() for n in names]}

    def timed(fn, key):
        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            rec["host"][key] += time.perf_counter() - t0
            return out
        return wrapper

    def make(gen, device=None, bs=8):
        run = saved[(volume, "make_volume_forward")](gen, device, bs)
        rec["mark"] = time.perf_counter()

        def forward(x):
            t0 = time.perf_counter()
            out = run(x)
            rec["forward"].append(time.perf_counter() - t0)
            return out
        return forward

    def scored(fn):
        fn = timed(fn, "metrics")

        def wrapper(gt, pred, **kw):
            out = fn(gt, pred, **kw)
            now = time.perf_counter()
            rec["labels"].append(np.array(pred))
            rec["scores"].append(out)
            rec["total"].append(now - rec["mark"])
            rec["mark"] = now
            return out
        return wrapper

    def kept(fn):
        def wrapper(*args, **kw):
            rec["results"].append(fn(*args, **kw))
            return rec["results"][-1]
        return wrapper

    volume.make_volume_forward = make
    volume.evaluate_mscmrseg = kept(saved[(volume, "evaluate_mscmrseg")])
    volume.evaluate_mmwhs = kept(saved[(volume, "evaluate_mmwhs")])
    metrics.compute_metrics_on_files = scored(saved[(metrics, "compute_metrics_on_files")])
    metrics.metrics_mmwhs_volume = scored(saved[(metrics, "metrics_mmwhs_volume")])
    for key, names in steps.items():
        for n in names:
            setattr(volume, n, timed(saved[(volume, n)], key))
    try:
        yield rec
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def _check_scores(result: dict, what: str) -> None:
    """Every metric of an evaluation finite: a mean Dice in [-1, 1] (the
    reference averages a patient's -1 sentinel in), every other number
    non-negative or the -1 sentinel."""
    for structure, values in result.items():
        for key, v in values.items():
            ok = -1.0 <= v <= 1.0 if key == "dice_mean" else (v == -1.0 or v >= 0.0)
            _require(bool(np.isfinite(v)) and ok, f"{what}: {structure} {key} = {v}")


def _per_patient(clock: dict, ids, card: str, what: str) -> str:
    _require(len(clock["forward"]) == len(clock["total"]) == len(ids), f"{what}: {len(clock['total'])} patients scored of {len(ids)}")
    parts = [f"{i}: forward {f:.3f} s + host {t - f:.3f} s" for i, f, t in zip(ids, clock["forward"], clock["total"])]
    fwd, tot = sum(clock["forward"]), sum(clock["total"])
    host = dict(clock["host"], other=tot - fwd - sum(clock["host"].values()))
    return (f"  {what}, seconds per patient (forward on the card, copies included; host: reading, resize, CLAHE, KLC, "
            f"metrics): {'; '.join(parts)}; the card's share {fwd / tot:.1%}; the host's seconds by step over the "
            f"patients: {', '.join(f'{k} {v:.3f}' for k, v in host.items())}, on {card}")


def _cli_training_run(torch, dev, rec, card, run_spec, pre_step_ms):
    """Train through a command-line entry point a user calls, on a dataset
    fabricated into a temporary directory that the run removes: 2 epochs with
    a full snapshot per epoch (timed, counted, its files checked) with cuDNN
    at its defaults, as the phases before it; then, with cuDNN deterministic
    (at its defaults two runs from one seed part ways in the first epoch:
    atomics in cuDNN's backward, amplified by twelve adversarial steps), the
    same 2 epochs, a second call that resumes at epoch 3 from the snapshot,
    and an uninterrupted 3-epoch run in other directories, whose epoch 3 the
    resumed one must equal.

    ``run_spec``: ``path`` (the kernel table's name of the run), ``main``
    (the entry point), ``argv`` (its flags but for the epochs and the
    directories), ``fabricate(root)``, ``want`` (the launches of the first 2
    epochs, from steps, cadence and validation batches), ``nets`` (the
    snapshot's networks), ``files`` (the checkpoints' name stems),
    ``steps`` (per epoch), ``val_batches``, ``bit_equal`` (whether the resumed
    epoch must equal the uninterrupted one bit for bit, or within the step
    tolerance), ``final_eval`` (the flags that skip the entry point's final
    evaluation of the best checkpoint in every call but the first, or None
    where it has none; the first call's is checked and timed), ``keep``
    (a directory the renamed best generator checkpoint is copied to before
    the run's directories go) and, optionally, ``resume=False``: no resumed
    runs (the host augmentation route's numpy generator is not in the
    snapshot, so a resumed run draws anew, as in the JAX package). The
    second epoch's ms per iteration and per batch waited for go into
    ``LOOP_MS[path]``."""
    from pointcloududa_torch.train import checkpoint, loop

    steps, val_batches = run_spec["steps"], run_spec["val_batches"]
    final = None
    tmp = tempfile.mkdtemp(prefix="pcuda_smoke_")
    train_s, valid_s, waits = [], [], []
    originals = loop.UDATrainer.train_epoch, loop.UDATrainer.validate, loop.DevicePrefetcher

    class TimedPrefetcher(loop.DevicePrefetcher):
        """Notes how long the training thread waited for each batch: what the loader does not hide."""

        def __call__(self, it):
            inner, epoch = super().__call__(it), []
            waits.append(epoch)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(inner)
                except StopIteration:
                    return
                epoch.append(time.perf_counter() - t0)
                yield item

    def timed(fn, into):
        def wrapper(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self)  # ends in the epoch's one metric fetch, which waits for the device
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return wrapper

    def run(tag, epochs, final_eval=False):
        skip = [] if final_eval or run_spec["final_eval"] is None else run_spec["final_eval"]
        argv = run_spec["argv"] + skip + ["-e", str(epochs), "-data_dir", os.path.join(tmp, "data"),
                                   "-workdir", os.path.join(tmp, tag, "weights"), "-logdir", os.path.join(tmp, tag, "runs"),
                                   "-resume", os.path.join(tmp, tag, "snap")]
        return _quiet(run_spec["main"], argv)[1]  # no device given: the card

    try:
        t0 = time.perf_counter()
        n_files = run_spec["fabricate"](os.path.join(tmp, "data"))
        print(f"  fabricated {n_files} slices in {time.perf_counter() - t0:.1f} s")
        loop.UDATrainer.train_epoch = timed(originals[0], train_s)
        loop.UDATrainer.validate = timed(originals[1], valid_s)
        loop.DevicePrefetcher = TimedPrefetcher
        torch.cuda.reset_peak_memory_stats(dev)

        with _CardLaunches(torch) as launched, _eval_clock() as clock:
            text = run("a", 2, final_eval=True)
        counts = launched.counts
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        want = run_spec["want"]
        _require(counts == want, f"launches in the training run {counts}, derived from steps, cadence and validation batches {want}")
        _record_launches(rec, run_spec["path"], counts, {k for k, v in want.items() if v})
        print(f"  launches on the card in 2 epochs of {steps} steps and {val_batches} validation batches each: "
              f"{counts}, as derived")
        _require("[1/2]" in text and "[2/2]" in text and "continuing at epoch" not in text, "the first run must train epochs 1 and 2 from scratch")
        scalars = _read_scalars(os.path.join(tmp, "a", "runs"))
        _require(sorted(scalars) == [1, 2], f"epochs logged: {sorted(scalars)}")
        for epoch, values in scalars.items():
            bad = [k for k, v in values.items() if not np.isfinite(v)]
            _require(not bad and len(values) >= 20, f"epoch {epoch}: non-finite or missing scalars {bad} of {len(values)}")
        apdx = text.splitlines()[0]
        weights = os.path.join(tmp, "a", "weights")
        files = sorted(os.listdir(weights))
        for stem in run_spec["files"]:
            name = f"{stem}_{apdx}"
            _require(name in files, f"{name} missing among {files}")
            payload = checkpoint.restore_pytree(os.path.join(weights, name))
            _require(payload["epoch"] == 2 and {"model", "optimizer"} <= set(payload["state"]["net"]), f"{name}: unexpected layout")
        best = [f for f in files if f.startswith(f"best_unet_model_checkpoint_{apdx}.Scr")]
        _require(len(best) == 1 and "model" in checkpoint.restore_pytree(os.path.join(weights, best[0]))["state"]["net"],
                 f"the renamed best checkpoint is missing among {files}")
        shutil.copy(os.path.join(weights, best[0]), run_spec["keep"])
        if run_spec["final_eval"] is not None:
            # the final evaluation of the best checkpoint, after training (its forward launches no kernel: the
            # counts above are the training's alone)
            _require(f"Evaluate the best model: {os.path.join(weights, best[0])}" in text and "Ave Dice:" in text
                     and len(clock["results"]) == 1, "the run did not evaluate its best checkpoint")
            _check_scores(clock["results"][0], "final evaluation")
            final = clock["results"][0]
            print(_per_patient(clock, CT_TEST, card, f"final evaluation of {best[0]} on {len(CT_TEST)} CT volumes of "
                               f"256 x 256 x {CT_TEST_Z}"))
        snap = checkpoint.restore_pytree(os.path.join(tmp, "a", "snap"))
        _require(snap["epoch"] == 2 and set(snap["nets"]) == run_spec["nets"] and snap["step"] == 2 * steps,
                 "snapshot: unexpected content")
        print(f"  {len(scalars[2])} scalars per epoch, all finite; checkpoints {files} and the snapshot load")
        if run_spec.get("resume", True):
            # resume: 2 epochs, a second call that continues at epoch 3, and 3 epochs without a break elsewhere
            torch.backends.cudnn.deterministic = True
            run("c", 2)
            text = run("c", 3)  # the same directories: resumes from the snapshot
            _require("continuing at epoch 3" in text and "[3/3]" in text and "[1/3]" not in text, "the second call must resume at epoch 3")
            run("b", 3)
            got, ref = _read_scalars(os.path.join(tmp, "c", "runs"))[3], _read_scalars(os.path.join(tmp, "b", "runs"))[3]
            _require(set(got) == set(ref), "the resumed and the uninterrupted epoch 3 log different scalars")
            worst, equal = 0.0, True
            for key, v in ref.items():
                _require(abs(got[key] - v) <= STEP_ATOL + STEP_RTOL * abs(v), f"epoch 3 {key}: resumed {got[key]} vs uninterrupted {v}")
                worst, equal = max(worst, abs(got[key] - v)), equal and got[key] == v
            _require(equal or not run_spec["bit_equal"], f"the resumed epoch 3 is not bit-equal to the uninterrupted one (max |diff| {worst})")
            print(f"  resumed epoch 3 vs an uninterrupted 3-epoch run: {len(ref)} scalars agree (max |diff| {worst:.3g}; "
                  f"{'bit-equal' if equal else 'not bit-equal'}; rtol {STEP_RTOL}, atol {STEP_ATOL}; cuDNN deterministic)")
    finally:
        loop.UDATrainer.train_epoch, loop.UDATrainer.validate, loop.DevicePrefetcher = originals
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)
    _loop_report(run_spec, steps, val_batches, train_s, valid_s, waits, peak_gib, pre_step_ms, card)
    return final


LOOP_MS: dict = {}  # path -> the second epoch's ms per iteration and per batch waited for (_cli_training_run)


def _loop_report(run_spec, steps, val_batches, train_s, valid_s, waits, peak_gib, pre_step_ms, card):
    """Print a run's epoch and iteration times and keep its second epoch's in ``LOOP_MS``."""
    # epochs in the order they ran: a 1-2 (cuDNN at its defaults), then deterministic: c 1-2, c 3, b 1-3
    per_it = [t / steps * 1e3 for t in train_s]
    LOOP_MS[run_spec["path"]] = dict(iteration_ms=per_it[1], wait_ms=sum(waits[1]) / steps * 1e3)
    print(f"  first run: epoch 1 {train_s[0] + valid_s[0]:.2f} s (training {train_s[0]:.2f} + validation {valid_s[0]:.2f}), "
          f"epoch 2 {train_s[1] + valid_s[1]:.2f} s ({train_s[1]:.2f} + {valid_s[1]:.2f}); peak memory {peak_gib:.2f} GiB, on {card}")
    resumed = ""
    if len(per_it) == 8:
        resumed = (f"; with cuDNN deterministic, the epochs that are not a call's first: median "
                   f"{statistics.median(per_it[i] for i in (3, 6, 7)):.2f} ms (all six: {', '.join(f'{t:.1f}' for t in per_it[2:])})")
    print(f"  training iteration in the loop (decode, prefetch, preprocess, step, the epoch's metric fetch; {steps} an epoch): "
          f"{per_it[1]:.2f} ms in epoch 2 of the first run (epoch 1: {per_it[0]:.2f}), of which the training thread waited for "
          f"its batches {sum(waits[1]) / steps * 1e3:.2f} ms ({waits[1][0] * 1e3:.1f} ms for the epoch's first, which nothing hides, "
          f"{sum(waits[1][1:]) * 1e3:.1f} ms for the other {steps - 1}); {run_spec['beside']} preprocess + step: "
          f"{pre_step_ms[0]:.2f} + {pre_step_ms[1]:.2f} = {sum(pre_step_ms):.2f} ms{resumed}; the validations of "
          f"{val_batches} batches: median {statistics.median(valid_s) * 1e3:.1f} ms, on {card}")


def phase_training_run(torch, dev, rec, card, pre_step_ms, keep):
    """(g) the MM-WHS training run through ``cli.train_mmwhs.main``, with its
    final evaluation; returns that evaluation's metrics."""
    from pointcloududa_torch.cli import train_mmwhs

    steps = -(-RUN_NS // RUN_BS)
    cadence_steps = -(-steps // RUN_VERT_T_EVERY)
    val_batches = sum(-(-RUN_SLICES[s] // RUN_BS) for s in ("mr_val", "ct_val", "ct_train"))
    return _cli_training_run(torch, dev, rec, card, dict(
        path="mmwhs_training_run", main=train_mmwhs.main,
        argv=["-bs", str(RUN_BS), "-ns", str(RUN_NS), "-nf", "32", "-aug", "light", "-softmax", "-d2", "-d4",
              "-vert_t_every", str(RUN_VERT_T_EVERY), "-dtype", "float32"], final_eval=["-skip_final_eval"], keep=keep,
        fabricate=lambda root: _fabricate_mmwhs(root, seed=5),
        want={
            "fps": 2 * (steps + cadence_steps),
            "chamfer_forward": 2 * (steps + cadence_steps + val_batches),
            "chamfer_nn_forward": 0,
            "chamfer_backward": 2 * steps,
            "bn_stats_forward": 2 * steps * 32,
            "bn_stats_backward": 2 * steps * 32,
            "bn_stats_forward_bf16": 0,
            "bn_stats_backward_bf16": 0,
        },
        nets={"gen", "d2", "d4"}, files=("unet_model_checkpoint", "entropy_dis", "point_dis"),
        steps=steps, val_batches=val_batches, bit_equal=False, beside="phase (f)",
    ), pre_step_ms)


# phase (h): the heavy pipeline at full width; raw MS-CMRSeg slices are the
# reference's processed PNGs, 256^2 (``origin_size``), cropped to 224 after
# augmentation
HEAVY_STEPS, HEAVY_RAW, HEAVY_TIMED = 4, 256, 5
# card-vs-CPU agreement of one heavy call (tests/test_torch_port_augment_heavy.py):
# the share of a sample's pixels beyond PIPE_ATOL on 0..255 where the
# superpixels touched it (their k-means parts ways on a last-bit difference)
# and where not, and of mask pixels. With every member on, a sample goes
# through 14 ops whose rounding steps (the median's integer input, the
# snapped fetch) turn a last-bit difference in the geometry into steps of 1
# that a median window spreads: EVERY_SHARE
PIPE_ATOL, SUPERPIXEL_SHARE, SAMPLE_SHARE, MASK_SHARE, EVERY_SHARE = 0.05, 0.5, 0.005, 0.005, 0.05


# CUDA runtime calls that make the host wait for the device
SYNCING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
                 "cudaMemset", "cudaFree", "cudaFreeHost")


def _trace_calls(torch, fn) -> dict:
    """The CUDA runtime calls ``fn`` makes and the device time of its
    kernels, from a ``torch.profiler`` trace of one call; fails on a call
    that makes the host wait for the device. ``None`` where the trace holds
    no runtime call (the profiler saw nothing: not measured)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pointcloududa_torch.utils.timer import SPAN_NAMES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("traced_call"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "traced_call" and e.device_type.name == "CPU"]
    if not window:
        return None
    lo, hi = window[0].time_range.start, window[0].time_range.end
    calls: dict = {}
    for e in events:
        if e.name.startswith("cuda") and e.device_type.name == "CPU" and lo <= e.time_range.start <= hi:
            calls[e.name] = calls.get(e.name, 0) + 1
    if not calls:
        return None
    # a record_function's range (this one, the program's spans) shows on the device too: not a kernel
    ranges = ("traced_call",) + SPAN_NAMES
    kernels = [e for e in events if e.device_type.name == "CUDA" and lo <= e.time_range.start and e.name not in ranges]
    syncing = {k: v for k, v in calls.items() if k in SYNCING_CALLS}
    _require(not syncing, f"synchronising CUDA runtime calls in one call: {syncing}")
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name[:60], (0, 0.0))
        by_name[e.name[:60]] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"runtime_calls": calls, "kernels": len(kernels), "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "host_ms": window[0].time_range.elapsed_us() / 1e3, "top_kernels": [[k, n, t] for k, (n, t) in top]}


def _trace_text(trace) -> str:
    if trace is None:
        return "the profiler trace holds no CUDA runtime call (launch count and device time not measured)"
    calls = trace["runtime_calls"]
    return (f"its profiler trace: {calls.get('cudaLaunchKernel', 0)} kernel launches, none of {', '.join(SYNCING_CALLS)}; "
            f"{trace['kernels']} kernels, {trace['kernel_ms']:.2f} ms of device time in {trace['host_ms']:.2f} ms of host time "
            f"(runtime calls: {calls}; the largest kernels by device time, [name, count, ms]: {trace['top_kernels']})")


def _heavy_raws(torch, cfg, n, dev, seed=0):
    """``n`` raw batches at 256^2 on the card (``synthetic_raw_batch`` draws
    at ``crop_size``, so it is asked for 256^2)."""
    import dataclasses

    from pointcloududa_torch.data.synthetic import synthetic_raw_batch

    big = dataclasses.replace(cfg, crop_size=HEAVY_RAW)
    return [_to_device(torch, synthetic_raw_batch(big, cfg.bs, seed=seed + s), dev) for s in range(n)]


def _agree(torch, got, want, draws, what, share=SAMPLE_SHARE):
    """Hold two heavy outputs (images, masks) as the CPU tests do: at most
    ``share`` of a sample's pixels beyond PIPE_ATOL (SUPERPIXEL_SHARE where
    the superpixels touched it); returns the worst share outside the
    superpixels."""
    (gi, gm), (wi, wm) = got, want
    differ = ((gi.cpu() - wi.cpu()).abs().amax(-1) > PIPE_ATOL).flatten(1).float().mean(1)
    touched = draws["active"][:, 0]
    _require(bool((differ[~touched] <= share).all()) and bool((differ[touched] <= SUPERPIXEL_SHARE).all()),
             f"{what}: shares of pixels beyond {PIPE_ATOL}: {differ.tolist()} (superpixels: {touched.tolist()}, "
             f"blur kinds: {draws['blur_choice'].tolist()})")
    if gm is not None:
        mask_share = float((gm.cpu() != wm.cpu()).float().mean())
        _require(mask_share <= MASK_SHARE, f"{what}: {mask_share:.4%} of mask pixels differ")
    return float(differ[~touched].max()) if bool((~touched).any()) else 0.0


def phase_heavy(torch, dev, rec, card, per_step):
    """(h) the heavy and medium pipelines on the card."""
    import dataclasses

    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
    from pointcloududa_torch.data.synthetic import synthetic_raw_batch
    from pointcloududa_torch.ops import augment
    from pointcloududa_torch.train.loop import make_device_preprocess
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils.timing import event_ms

    cfg = mscmrseg_default(d1=True, d2=True, d4=True, bs=16, aug="heavy", compute_dtype="float32",
                           chamfer_impl="pallas", bn_stats_impl="pallas")
    _require((cfg.crop_size, cfg.n_class, cfg.aug) == (224, 4, "heavy"), "not the MS-CMRSeg widths and default pipeline")
    state = create_train_state(cfg, seed=0)
    step = make_train_step(cfg, state.models, state.optimizers)
    preprocess = make_device_preprocess(cfg, train=True, device_augment=True)
    gen, host = torch.Generator(device=dev).manual_seed(21), torch.Generator().manual_seed(22)
    raws = _heavy_raws(torch, cfg, HEAVY_STEPS, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # raw 256^2 batch -> heavy augmentation of both streams -> crop 224 -> step, four times
    pre_ms, step_ms, history = [], [], []
    with _CardLaunches(torch) as launched:
        for raw in raws:
            batch, t = event_ms(lambda: preprocess(gen, raw, host_generator=host))
            pre_ms.append(t)
            for side in ("s", "t"):
                img = batch[f"img_{side}"]
                _require(tuple(img.shape) == (16, 224, 224, 3) and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                         f"img_{side}: {tuple(img.shape)} in [{float(img.min())}, {float(img.max())}], not 224^2 in [0, 1]")
            _require(bool((batch["mask_s"].sum(-1) == 1).all()) and batch["mask_s"].shape[-1] == 4, "labels left {0..3}")
            (state, metrics), t = event_ms(lambda: step(state, batch))
            step_ms.append(t)
            history.append(metrics)
    counts = launched.counts
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    for i, metrics in enumerate(history):
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if not np.isfinite(v)]
        _require(not bad, f"heavy step {i}: non-finite metrics {bad}")
        print(f"  step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(values.items())))
    want = {name: n * HEAVY_STEPS for name, n in per_step.items()}
    _require(counts == want, f"launches in {HEAVY_STEPS} heavy preprocess + step calls {counts}, phase (c)'s per step x {HEAVY_STEPS}: {want}")
    _record_launches(rec, "mscmrseg_heavy", counts, {k for k, v in want.items() if v})
    print(f"  launches on the card in {HEAVY_STEPS} heavy preprocess + step calls: {counts} (phase (c)'s per step "
          f"x {HEAVY_STEPS})")
    pre_heavy, step_med = statistics.median(pre_ms[1:]), statistics.median(step_ms[2:])  # step 2 is the capture
    print(f"  MS-CMRSeg heavy device preprocess (bs 16, 256^2 -> 224^2, both streams, traced): median {pre_heavy:.2f} ms over "
          f"calls 1-{HEAVY_STEPS - 1} (all: {', '.join(f'{t:.2f}' for t in pre_ms)}); train step (D1+D2+D4, all kernels): "
          f"median {step_med:.2f} ms replayed (all: {', '.join(f'{t:.2f}' for t in step_ms)}); peak memory {peak_gib:.2f} GiB, "
          f"on {card}")

    # no host-device synchronisation in a heavy preprocess: PyTorch's sync
    # check raises on one, and the CUDA runtime calls of one call in a
    # profiler trace include no synchronising call
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        preprocess(gen, raws[0], host_generator=host)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    trace = _trace_calls(torch, lambda: preprocess(gen, raws[1], host_generator=host))
    print(f"  one heavy preprocess under torch.cuda.set_sync_debug_mode('error'): no synchronisation; {_trace_text(trace)}")

    # medium: one preprocess + step
    med_cfg = dataclasses.replace(cfg, aug="aug2")
    batch = make_device_preprocess(med_cfg, True, True)(gen, raws[2], host_generator=host)
    state, metrics = step(state, batch)
    values = {k: float(v) for k, v in metrics.items()}
    _require(all(np.isfinite(v) for v in values.values()) and float(batch["img_s"].max()) <= 1.0, f"medium step: {values}")
    print(f"  medium (aug2) preprocess + step: {len(values)} metrics finite (seg_loss {values['seg_loss']:.5f})")

    # preprocess time by pipeline, beside the step: device span between two
    # events (host time included) and host time to enqueue with the card idle
    spans = {}
    for aug in ("heavy", "aug2", "light", ""):
        pre = make_device_preprocess(dataclasses.replace(cfg, aug=aug), True, True)
        pre(gen, raws[0], host_generator=host)  # warm-up
        ms, host_ms = [], []
        for i in range(HEAVY_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, t = event_ms(lambda: pre(gen, raws[i % HEAVY_STEPS], host_generator=host))
            host_ms.append((time.perf_counter() - t0) * 1e3)
            ms.append(t)
        spans[aug or "none"] = (statistics.median(ms), statistics.median(host_ms))
    print("  MS-CMRSeg preprocess by pipeline (bs 16, both streams, median of 5): " + "; ".join(
        f"{k} {v[0]:.2f} ms ({v[1]:.2f} ms host to return)" for k, v in spans.items())
          + f"; the train step beside them {step_med:.2f} ms, on {card}")

    # MM-WHS -aug heavy: clouds regenerated from the warped masks by FPS
    mcfg = mmwhs_default(softmax=True, d2=True, d4=True, aug="heavy", bs=16, compute_dtype="float32",
                         chamfer_impl="pallas", bn_stats_impl="pallas")
    mstate = create_train_state(mcfg, seed=0)
    mstep = make_train_step(mcfg, mstate.models, mstate.optimizers)
    mpre = make_device_preprocess(mcfg, True, True)
    mraws = [_to_device(torch, synthetic_raw_batch(mcfg, mcfg.bs, seed=30 + s), dev) for s in range(2)]
    heavy = augment.heavy()
    shape = (256, 256, 3)
    mms = []
    with _CardLaunches(torch) as launched:
        for raw in mraws:
            draws = {f"aug_{side}": augment.sample_draws(gen, heavy, mcfg.bs, dev, shape, host) for side in ("s", "t")}
            batch, t = event_ms(lambda: mpre(gen, raw, draws=draws))
            (mstate, metrics), t2 = event_ms(lambda: mstep(mstate, batch))
            mms.append((t, t2))
            values = {k: float(v) for k, v in metrics.items()}
            _require(all(np.isfinite(v) for v in values.values()), f"MM-WHS heavy step: {values}")
            blank = torch.zeros((mcfg.bs, 256, 256, 3), device=dev)
            for side in ("s", "t"):
                _, warped = augment.augment_from_draws(heavy, blank, raw[f"mask_{side}"], draws[f"aug_{side}"])
                _require(_on_candidates(torch, batch[f"vert_{side}"] * 255.0, warped),
                         f"vert_{side}: a point off the warped mask's candidates")
    mcounts = launched.counts
    _require(mcounts["fps"] == 2 * len(mraws), f"fps launched {mcounts['fps']} times in {len(mraws)} steps, not twice per step")
    _record_launches(rec, "mmwhs_heavy", mcounts, {"fps", "chamfer_forward", "chamfer_backward", "bn_stats_forward", "bn_stats_backward"})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mpre(gen, mraws[0], host_generator=host)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    mtrace = _trace_calls(torch, lambda: mpre(gen, mraws[1], host_generator=host))
    print(f"  MM-WHS -aug heavy (softmax D2+D4, 256^2): 2 preprocess + step calls, metrics finite, fps launched "
          f"{mcounts['fps']} times, clouds on the warped masks' candidates; preprocess {mms[1][0]:.2f} ms, step {mms[1][1]:.2f} ms "
          f"(second call, the capture's, traced); its preprocess: no synchronisation under the sync check, {_trace_text(mtrace)}; launches {mcounts}, "
          f"on {card}")
    del mstate, mstep

    # one fixed set of draws on the card against the same call on the CPU
    img, masks = raws[0]["img_s"], raws[0]["mask_s"]
    draws = augment.sample_draws(gen, heavy, cfg.bs, dev, shape, host)
    cpu = lambda d: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in d.items()}  # noqa: E731
    worst = _agree(torch, augment.augment_from_draws(heavy, img, masks, draws),
                   augment.augment_from_draws(heavy, img.cpu(), masks.cpu(), cpu(draws)), draws, "drawn heavy call")
    fired = draws["active"].sum(0).tolist()
    # every member but the superpixels on 4 samples, and the superpixels alone
    every = dict(draws, active=torch.ones((cfg.bs, 15), dtype=torch.bool))
    every["active"][:, 0] = False
    sub = lambda d: {k: (v[:4] if torch.is_tensor(v) and v.dim() and v.shape[0] == cfg.bs else v) for k, v in d.items()}  # noqa: E731
    worst_every = _agree(torch, augment.augment_from_draws(heavy, img[:4], masks[:4], sub(every)),
                         augment.augment_from_draws(heavy, img[:4].cpu(), masks[:4].cpu(), cpu(sub(every))), sub(every),
                         "every member but the superpixels", EVERY_SHARE)
    only_sp = dict(draws, active=torch.zeros((cfg.bs, 15), dtype=torch.bool))
    only_sp["active"][:, 0] = True
    _agree(torch, augment.augment_from_draws(heavy, img[:4], masks[:4], sub(only_sp)),
           augment.augment_from_draws(heavy, img[:4].cpu(), masks[:4].cpu(), cpu(sub(only_sp))), sub(only_sp), "superpixels")
    print(f"  heavy call on the card vs the CPU from one set of draws (bs 16, members fired {fired}): worst share of a sample's "
          f"pixels beyond {PIPE_ATOL} outside the superpixels {worst:.4%}; every member but the superpixels on 4 samples (blur "
          f"kinds {draws['blur_choice'][:4].tolist()}): {worst_every:.4%}; the superpixels alone on 4 samples within "
          f"{SUPERPIXEL_SHARE:.0%}; masks within {MASK_SHARE:.1%} everywhere")

    # each SomeOf member forced on for the whole batch, alone: the heavy call
    # with the outer children off; the base is the same call with no member
    quiet = dict(draws, gates=torch.zeros_like(draws["gates"]))

    def member_ms(active, choice=None):
        d = dict(quiet, active=active)
        if choice is not None:
            d["blur_choice"] = torch.full((cfg.bs,), choice, dtype=torch.int64)
        augment.augment_from_draws(heavy, img, masks, d)
        return statistics.median(event_ms(lambda: augment.augment_from_draws(heavy, img, masks, d))[1] for _ in range(3))

    base = member_ms(torch.zeros((cfg.bs, 15), dtype=torch.bool))
    per_member = {}
    for j, name in enumerate(augment.MEMBERS):
        active = torch.zeros((cfg.bs, 15), dtype=torch.bool)
        active[:, j] = True
        per_member[name] = member_ms(active)
        if name == "blur":
            for k, kind in enumerate(augment.BLURS):
                per_member[kind] = member_ms(active, k)
    print(f"  heavy call (bs 16, 256^2, image + mask) with each member forced on for every sample, ms: no member {base:.2f}; "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_member.items()) + f", on {card}")
    print("  HEAVY_JSON " + json.dumps({"card": card, "base_ms": base, "member_ms": per_member, "preprocess_ms": spans,
                                        "step_ms": step_med, "heavy_pre_ms": pre_heavy, "peak_gib": peak_gib,
                                        "heavy_trace": trace, "mmwhs_heavy_trace": mtrace}))
    return pre_heavy, step_med


# phase (i): a fabricated MS-CMRSeg dataset, per split: its mask directory,
# datalist and number of PNG slices
MS_SPLITS = {"trainA": ("trainAmask", "aug_trainA.csv", 32), "trainB": ("trainBmask", "aug_trainB.csv", 32),
             "testA": ("testAmask", "testA.csv", 16), "trainB_orig": ("trainBmask_orig", "testB.csv", 16)}


def _fabricate_mscmrseg(root: str, seed: int) -> int:
    """An MS-CMRSeg dataset in the directory contract of ``data/mscmrseg.py``,
    written with ``utils/png.py``: 256 x 256 x 3 uint8 slices (noise around
    the structures), grey masks of three filled ellipses in the reference's
    values {0, 85, 212, 255}, (300, 3) vertex files on the 0..255 scale, and
    the four datalists."""
    from pointcloududa_torch.data.manifest import write_ids
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks
    from pointcloududa_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    values = np.array([0, 85, 212, 255], np.uint8)
    for j, (split, (mask_split, datalist, n)) in enumerate(MS_SPLITS.items()):
        img_dir, mask_dir = os.path.join(root, "processed", split), os.path.join(root, "processed", mask_split)
        vert_dir = os.path.join(root, "vertices", split)
        for d in (img_dir, mask_dir, vert_dir):
            os.makedirs(d, exist_ok=True)
        ids = [f"{split}_slice{i}" for i in range(n)]
        for _id, mask in zip(ids, synthetic_blob_masks(n, HEAVY_RAW, seed=seed + 1 + j, n_class=4)):
            img = np.clip(rng.normal(90.0, 30.0, (HEAVY_RAW, HEAVY_RAW, 3)) + 40.0 * mask[..., None], 0, 255).astype(np.uint8)
            write_png(os.path.join(img_dir, f"{_id}.png"), img)
            write_png(os.path.join(mask_dir, f"{_id}.png"), values[mask])
            np.save(os.path.join(vert_dir, f"{_id}.npy"), (rng.uniform(size=(300, 3)) * 255.0).astype(np.float32))
        write_ids(os.path.join(root, datalist), ids)
    return sum(n for _, _, n in MS_SPLITS.values())


def phase_mscmrseg_run(torch, dev, rec, card, per_step, pre_step_ms, keep):
    """(i) the reference's MS-CMRSeg command through ``cli.train_mscmrseg.main``:
    no ``-aug`` (the heavy pipeline), ``-d1 -d2 -d4``."""
    from pointcloududa_torch.cli import train_mscmrseg

    steps = -(-RUN_NS // RUN_BS)
    val_batches = sum(-(-MS_SPLITS[s][2] // RUN_BS) for s in ("testA", "trainB_orig", "trainB"))
    want = {name: n * 2 * steps for name, n in per_step.items()}
    want["chamfer_forward"] += 2 * val_batches  # one forward per validation batch, in each of the 2 epochs
    _cli_training_run(torch, dev, rec, card, dict(
        path="mscmrseg_training_run", main=train_mscmrseg.main,
        argv=["-bs", str(RUN_BS), "-ns", str(RUN_NS), "-d1", "-d2", "-d4", "-dtype", "float32"],
        fabricate=lambda root: _fabricate_mscmrseg(root, seed=7), want=want,
        nets={"gen", "d1", "d2", "d4"}, files=("unet_model_checkpoint", "out_dis", "entropy_dis", "point_dis"),
        steps=steps, val_batches=val_batches, bit_equal=True, beside="phase (h)", final_eval=None, keep=keep,
    ), pre_step_ms)


def _fabricate_lge_test(root: str, seed: int) -> int:
    """The LGE test patients of ``eval/volume.py:evaluate_mscmrseg``: the
    ground truth at each patient's native size (``LGE_TEST``) in the raw
    values {200, 500, 600}, written by the port's ``save_nii``, and per slice
    a 256^2 x 3 uint8 PNG (``utils/png.py``) of noise brightened where the
    slice's labels, resized to 256^2 by nearest neighbour, are set."""
    from pointcloududa_torch.utils.nifti import save_nii
    from pointcloududa_torch.utils.png import write_png

    gt_dir = os.path.join(root, "raw_data", "labels", "lge_test_gt")
    png_dir = os.path.join(root, "processed", "trainB")
    os.makedirs(gt_dir)
    os.makedirs(png_dir)
    rng = np.random.default_rng(seed)
    raw = np.array([0, 200, 500, 600], np.int16)
    for pat_id, (x, y, z) in LGE_TEST.items():
        labels = _ellipsoids((z, y, x), 3, rng)  # (Z, Y, X): the evaluation's masks are the nii transposed
        save_nii(os.path.join(gt_dir, f"patient{pat_id}_LGE_manual.nii.gz"), raw[labels].T)
        rows, cols = np.arange(256) * y // 256, np.arange(256) * x // 256
        for i in range(z):
            canvas = labels[i][rows][:, cols].astype(np.float64)
            img = np.clip(rng.normal(90.0, 30.0, (256, 256, 3)) + 40.0 * canvas[..., None], 0, 255).astype(np.uint8)
            write_png(os.path.join(png_dir, f"pat_{pat_id}_lge_{i}.png"), img)
    return sum(z for _, _, z in LGE_TEST.values())


def _scaled_err(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


def phase_evaluation(torch, dev, rec, card, keep, final_eval, tmp):
    """(j) evaluation at full width on the card, through the evaluate CLIs,
    the predictor and its export, with no kernel launched, in float32. The
    test patients are fabricated under ``tmp``, which phase (k) reads again;
    returns the label volumes on the card of the MS-CMRSeg patients (phase
    (i)'s generator, and the untrained one) and of the CT volumes, and the
    untrained generator's file."""
    from pointcloududa_torch.cli import evaluate_mmwhs, evaluate_mscmrseg
    from pointcloududa_torch.cli.common import restored_generator
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
    from pointcloududa_torch.eval.predictor import Predictor, export_predictor, load_exported
    from pointcloududa_torch.train import checkpoint
    from pointcloududa_torch.train.state import build_generator
    from pointcloududa_torch.utils.timing import event_ms

    best_ms = [os.path.join(keep, f) for f in os.listdir(keep) if ".d1lr" in f]
    best_mm = [os.path.join(keep, f) for f in os.listdir(keep) if ".softmax" in f]
    _require(len(best_ms) == len(best_mm) == 1, f"the best checkpoints of phases (g) and (i): {os.listdir(keep)}")
    _reset_launches()
    t0 = time.perf_counter()
    n_slices = _fabricate_lge_test(os.path.join(tmp, "lge"), seed=9) + _fabricate_ct_test(os.path.join(tmp, "ct"), seed=5)
    print(f"  fabricated {n_slices} test slices in {time.perf_counter() - t0:.1f} s")

    # MS-CMRSeg: phase (i)'s best generator, the reference's evaluation flags, on the card
    lge_ids = list(LGE_TEST)
    argv = ["-model_dir", best_ms[0], "-from_name", "-data_dir", os.path.join(tmp, "lge"), "-klc", "-clahe",
            "-pat_lo", str(lge_ids[0]), "-pat_hi", str(lge_ids[-1] + 1), "-dtype", "float32"]
    plots, per_patient = os.path.join(tmp, "plots"), os.path.join(tmp, "lge.csv")
    with _eval_clock() as card_run:
        got, text = _quiet(evaluate_mscmrseg.main, argv + ["-toplot", plots, "-csv", per_patient])
    _require("Ave Dice:" in text, "no Ave Dice line")
    _check_scores(got, "MS-CMRSeg")
    for pat_id, labels in zip(lge_ids, card_run["labels"]):
        x, y, z = LGE_TEST[pat_id]
        _require(labels.shape == (z, y, x) and set(np.unique(labels)) <= {0, 200, 500, 600},
                 f"patient {pat_id}: labels {labels.shape} {np.unique(labels)}")
    n_plots = len(os.listdir(plots))
    with open(per_patient) as f:
        n_rows = len(f.read().strip().splitlines()) - 1
    _require(n_plots == sum(LGE_TEST[p][2] for p in lge_ids) and n_rows == 3 * len(lge_ids),
             f"{n_plots} triptychs, {n_rows} CSV rows")
    print(_per_patient(card_run, lge_ids, card, "MS-CMRSeg (-klc -clahe)"))
    print(f"  MS-CMRSeg metrics: {json.dumps(got)}; {n_plots} triptychs, {n_rows} CSV rows")

    # the same weights in the reference's callback layout, as torch 1.4 wrote it
    net = checkpoint.restore_pytree(best_ms[0])["state"]["net"]
    released = os.path.join(tmp, "released_generator.pt")
    torch.save({"epoch": 2, "model_state_dict": net["model"], "optimizer_state_dict": net["optimizer"]}, released,
               _use_new_zipfile_serialization=False)
    with _eval_clock() as again:
        same, _ = _quiet(evaluate_mscmrseg.main, ["-model_dir", released, "-d4"] + argv[3:])
    _require(same == got and all(np.array_equal(a, b) for a, b in zip(again["labels"], card_run["labels"])),
             "the reference's callback layout gives other labels or metrics")
    print("  the same weights in the reference's callback layout (legacy serialisation): equal labels and metrics")

    # the same evaluation on the CPU; then, since a generator trained for 2 epochs on fabricated slices labels
    # nearly every voxel background, an untrained one from a seed (a bare state_dict, the third layout), whose
    # argmax has work to do everywhere, on the card and on the CPU (Dice only: the distances' time is the host's)
    with _eval_clock() as cpu_run:
        _quiet(evaluate_mscmrseg.main, argv, device="cpu")
    untrained = os.path.join(tmp, "untrained_generator.pt")
    torch.save(build_generator(mscmrseg_default(d4=True), torch.Generator().manual_seed(0)).state_dict(), untrained)
    dice_only = ["-model_dir", untrained, "-d4", "-ifhd", "0", "-ifasd", "0"] + argv[3:]
    with _eval_clock() as card_untrained:
        _quiet(evaluate_mscmrseg.main, dice_only)
    with _eval_clock() as cpu_untrained:
        _quiet(evaluate_mscmrseg.main, dice_only, device="cpu")
    for what, on_card, on_host in (("trained", card_run, cpu_run), ("untrained", card_untrained, cpu_untrained)):
        shares = []
        for i, pat_id in enumerate(lge_ids):
            a, b = on_card["labels"][i], on_host["labels"][i]
            shares.append(float((a != b).mean()))
            _require(shares[-1] <= LABEL_SHARE, f"{what}, patient {pat_id}: card and CPU labels differ in {shares[-1]:.4%} of the voxels")
            _require(shares[-1] > 0.0 or on_card["scores"][i] == on_host["scores"][i],
                     f"{what}, patient {pat_id}: equal labels, other metrics")
        counts = [dict(zip(*(v.tolist() for v in np.unique(labels, return_counts=True)))) for labels in on_card["labels"]]
        print(f"  card against CPU, {what} generator: label voxels that differ per patient "
              f"{', '.join(f'{s:.4%}' for s in shares)} (allowed {LABEL_SHARE:.2%}; metrics equal wherever the labels "
              f"are); voxels of each label per patient on the card {counts}; the CPU's forward "
              f"{sum(on_host['forward']):.2f} s against the card's {sum(on_card['forward']):.2f} s")

    # MM-WHS: phase (g)'s best generator on its four CT volumes, the architecture from the file's name
    csv_path = os.path.join(tmp, "mmwhs.csv")
    with _eval_clock() as ct_run:
        ct, text = _quiet(evaluate_mmwhs.main, ["-weight_dir", best_mm[0], "-from_name", "-save", "-csv", csv_path,
                                                 "-model_name", "smoke", "-data_dir", os.path.join(tmp, "ct"),
                                                 "-dtype", "float32"])
    _require("d4lr" in text and "Ave Dice:" in text, "no tag listing or no Ave Dice line")
    _check_scores(ct, "MM-WHS")
    _require(ct == final_eval, "the evaluate CLI and phase (g)'s final evaluation give other metrics")
    with open(csv_path) as f:
        _require(len(f.read().strip().splitlines()) == 1 + len(CT_TEST), "MM-WHS CSV rows")
    print(_per_patient(ct_run, CT_TEST, card, "MM-WHS"))
    print(f"  MM-WHS metrics, equal to phase (g)'s final evaluation: {json.dumps(ct)}")

    # the predictor at both widths, and its export
    for cfg, best in ((mscmrseg_default(d1=True, d2=True, d4=True), best_ms[0]),
                      (mmwhs_default(softmax=True, d2=True, d4=True), best_mm[0])):
        size = cfg.crop_size
        gen = restored_generator(cfg, best, dev)
        predictor = Predictor(cfg, gen, batch_size=8)  # no device given: the card
        x = np.random.default_rng(size).uniform(size=(11, size, size, 3)).astype(np.float32)
        logits, points = predictor(x)
        _require(logits.shape == (11, size, size, cfg.n_class) and points.shape == (11, 300, 3)
                 and bool(np.isfinite(logits).all() and np.isfinite(points).all()), "predictor outputs")
        tail, tail_points = predictor(x[8:])  # 3 images padded to 8
        pad_err = max(_scaled_err(tail, logits[8:]), _scaled_err(tail_points, points[8:]))
        _require(pad_err <= LOGIT_SCALED_TOL, f"the tail padding changed the outputs: {pad_err:.3g}")
        cpu_logits, cpu_points = Predictor(cfg, gen, batch_size=2, device="cpu")(x[:2])
        cpu_err = max(_scaled_err(logits[:2], cpu_logits), _scaled_err(points[:2], cpu_points))
        _require(cpu_err <= LOGIT_SCALED_TOL, f"card against CPU logits: {cpu_err:.3g}")
        times = [event_ms(lambda: predictor(x[:8]))[1] for _ in range(6)][1:]
        t0 = time.perf_counter()
        blob = export_predictor(cfg, gen, batch_size=8)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        run = load_exported(blob)
        load_s = time.perf_counter() - t0
        x_dev = torch.from_numpy(x[:8]).to(dev)
        out_logits, out_points = run(x_dev)
        exp_err = max(_scaled_err(out_logits.cpu().numpy(), logits[:8]), _scaled_err(out_points.cpu().numpy(), points[:8]))
        _require(exp_err <= LOGIT_SCALED_TOL, f"the exported program against the predictor: {exp_err:.3g}")
        fwd = [event_ms(lambda: run(x_dev))[1] for _ in range(6)][1:]
        print(f"  Predictor nf {cfg.filters}, bs 8, {size}^2, {cfg.n_class} classes + points: {statistics.median(times):.2f} ms a batch "
              f"(numpy in and out, between CUDA events; {8e3 / statistics.median(times):.1f} images/s), the exported "
              f"program on a batch on the card {statistics.median(fwd):.2f} ms; tail padding {pad_err:.3g}, card "
              f"against CPU {cpu_err:.3g}, export against predictor {exp_err:.3g} (max |diff| / max |value|, allowed "
              f"{LOGIT_SCALED_TOL}); artifact {len(blob)} bytes, exported in {export_s:.2f} s, loaded in {load_s:.2f} s, "
              f"on {card}")
        del gen, predictor, run
    counts = _launch_counts()
    _require(not any(counts.values()), f"kernels launched while evaluating: {counts} (eval mode normalises with running statistics)")
    _record_launches(rec, "evaluation", counts, set())
    print(f"  launches on the evaluation path: {counts}")
    return dict(lge=card_run["labels"], lge_untrained=card_untrained["labels"], ct=ct_run["labels"], untrained=untrained)

# phase (k): compute_dtype="bfloat16" at full width. Steps per dtype and path
# (the first pays cuDNN's choice and the allocator's growth; the others are
# timed). One-step kernels-vs-plain agreement of the bf16 step metrics: bf16
# rounds where f32 differs by a last bit (the kernels' and PyTorch's sums), and
# a flipped rounding spreads through the layers, so the CPU tests'
# tolerance against JAX's bf16 step holds here: 5x the f32 one, 25x for
# d4_loss, whose fast-variance norms amplify it (tests/test_torch_port_bf16.py).
# bf16 against f32 labels of the same weights: the share of a patient's label
# voxels that may differ, where bf16 noise moves a near-tie.
BF16_STEPS = 5
BF16_STEP_SCALE, BF16_D4_SCALE = 5.0, 25.0
BF16_LABEL_SHARE = 0.05
# a profiled step's kernels by kind, on their names (the first kind that matches)
KERNEL_KINDS = (
    ("layout transform", ("nchwToNhwc", "nhwcToNchw")),
    ("port kernels", ("stats_forward_kernel", "stats_backward_kernel", "fused_forward_kernel", "side_grad_kernel",
                      "fps_kernel")),
    ("convolution", ("implicit_gemm", "fprop", "dgrad", "wgrad", "conv", "cudnn")),
    ("matmul", ("gemm",)),
    ("convolution", ("xmma", "cutlass")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def _bf16_tol_ok(key: str, got: float, want: float) -> bool:
    scale = BF16_D4_SCALE if key == "d4_loss" else BF16_STEP_SCALE
    if key.startswith("dis"):  # accuracies over 16 samples or a few hundred patches: a flipped decision or two
        return abs(got - want) <= 2.0 / 16
    return abs(got - want) <= scale * (STEP_ATOL + STEP_RTOL * abs(want))


def _step_profile(torch, fn) -> dict | None:
    """Device time of one call of ``fn`` by kernel kind (``KERNEL_KINDS``),
    from a ``torch.profiler`` trace: per kind ms and kernel count, the sum,
    and the traced window on the host clock (it ends in a synchronize).
    ``None`` where the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from pointcloududa_torch.utils.timer import SPAN_NAMES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profiled_step"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = [e for e in events if e.name == "profiled_step" and e.device_type.name == "CPU"]
    kernels = [e for e in events if e.device_type.name == "CUDA" and e.name not in ("profiled_step",) + SPAN_NAMES]
    if not window or not kernels:
        return None
    kinds: dict = {}
    for e in kernels:
        kind = next((k for k, keys in KERNEL_KINDS if any(key in e.name for key in keys)), "other")
        n, t = kinds.get(kind, (0, 0.0))
        kinds[kind] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    return dict(kinds=dict(sorted(kinds.items(), key=lambda kv: -kv[1][1])), kernel_ms=sum(t for _, t in kinds.values()),
                window_ms=window[0].time_range.elapsed_us() / 1e3,
                kernels=len(kernels))


def _profile_text(prof) -> str:
    if prof is None:
        return "the profiler saw no kernel (not measured)"
    kinds = "; ".join(f"{k} {t:.2f} ms ({t / prof['kernel_ms']:.1%}, {n} kernels)" for k, (n, t) in prof["kinds"].items())
    return f"{prof['kernel_ms']:.2f} ms of kernels ({prof['kernels']}) in a {prof['window_ms']:.2f} ms window: {kinds}"


def _share(a, b) -> float:
    _require(a.shape == b.shape, f"label volumes {a.shape} and {b.shape}")
    return float((a != b).mean())


def phase_bf16(torch, dev, rec, card, heavy_pre_ms, keep, tmp, f32_labels):
    """(k) compute_dtype="bfloat16" at full width, every kernel on: both steps
    beside their float32 twins, one step kernels against plain, the eval
    step, the reference's MS-CMRSeg command at its default (bf16, heavy
    augmentation) with a resumed epoch, and both evaluate CLIs with
    ``-dtype bfloat16`` on phase (j)'s patients."""
    import dataclasses

    from pointcloududa_torch.cli import evaluate_mmwhs, evaluate_mscmrseg, train_mscmrseg
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default
    from pointcloududa_torch.data.synthetic import synthetic_batch, synthetic_eval_batch, synthetic_raw_batch
    from pointcloududa_torch.models.unet import TwinBatchNorm
    from pointcloududa_torch.train.loop import make_device_preprocess
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_eval_step, make_train_step
    from pointcloududa_torch.utils.timing import event_ms

    base = {
        "mscmrseg": mscmrseg_default(d1=True, d2=True, d4=True, bs=16, chamfer_impl="pallas", bn_stats_impl="pallas"),
        "mmwhs": mmwhs_default(softmax=True, d2=True, d4=True, aug="light", bs=16, chamfer_impl="pallas",
                               bn_stats_impl="pallas"),
    }
    data = {
        "mscmrseg": [_to_device(torch, synthetic_batch(base["mscmrseg"], 16, seed=s), dev) for s in range(BF16_STEPS)],
        "mmwhs": [_to_device(torch, synthetic_raw_batch(base["mmwhs"], 16, seed=s), dev) for s in range(BF16_STEPS)],
    }
    per_step, timing = {}, {}
    for workload, cfg0 in base.items():
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(cfg0, compute_dtype=dtype)
            state = create_train_state(cfg, seed=0)
            step = make_train_step(cfg, state.models, state.optimizers)
            preprocess = make_device_preprocess(cfg, train=True, device_augment=True) if workload == "mmwhs" else None
            gen = torch.Generator(device=dev).manual_seed(7)
            bn_in = set()
            hooks = [m.register_forward_pre_hook(lambda _m, a: bn_in.add((tuple(a[0].shape), a[0].dtype)))
                     for m in state.models[0].modules() if isinstance(m, TwinBatchNorm)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            pre_ms, step_ms, history = [], [], []
            with _CardLaunches(torch) as launched:
                for item in data[workload]:
                    batch = item
                    if preprocess is not None:
                        batch, t = event_ms(lambda: preprocess(gen, item))
                        pre_ms.append(t)
                    (state, metrics), t = event_ms(lambda: step(state, batch))
                    step_ms.append(t)
                    history.append(metrics)
            counts = launched.counts
            peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
            for h in hooks:
                h.remove()
            batch = data[workload][-1] if preprocess is None else preprocess(gen, data[workload][-1])
            prof = _step_profile(torch, lambda: step(state, batch))
            want_in = {(shape, getattr(torch, dtype)) for shape in BN_SHAPES[workload]}
            _require(bn_in == want_in, f"{workload} {dtype}: BatchNorm inputs {sorted(map(str, bn_in))}")
            for i, m in enumerate(history):
                bad = [k for k, v in m.items() if not np.isfinite(float(v))]
                _require(not bad, f"{workload} {dtype} step {i}: non-finite metrics {bad}")
            if dtype == "bfloat16":
                print(f"  {workload} bf16 step {BF16_STEPS - 1}: "
                      + ", ".join(f"{k} {float(v):.5f}" for k, v in sorted(history[-1].items())))
                n = BF16_STEPS
                _require(counts["bn_stats_forward"] == counts["bn_stats_backward"] == 0
                         and counts["bn_stats_forward_bf16"] == counts["bn_stats_backward_bf16"] == 32 * n
                         and (counts["chamfer_forward"], counts["chamfer_backward"]) == (2 * n, n)
                         and counts["fps"] == (2 * n if workload == "mmwhs" else 0),
                         f"launches of {n} bf16 {workload} steps: {counts}")
                _record_launches(rec, f"{workload}_bf16", counts, {k for k, v in counts.items() if v})
                print(f"  launches on the card in {n} bf16 {workload} {'preprocess + ' if preprocess else ''}step calls: "
                      f"{counts}")
                per_step[workload] = {k: v // n for k, v in counts.items()}
            # step 1 eager, step 2 the capture
            timing[(workload, dtype)] = dict(step=statistics.median(step_ms[2:]), all=step_ms, peak=peak_gib,
                                            pre=statistics.median(pre_ms[1:]) if pre_ms else 0.0)
            print(f"  {workload} {dtype} step, profiled once more: {_profile_text(prof)}")
            del state, step, preprocess, history, batch
            torch.cuda.empty_cache()
        f, b = timing[(workload, "float32")], timing[(workload, "bfloat16")]
        pre = f" (device preprocess {f['pre']:.2f} and {b['pre']:.2f} ms)" if workload == "mmwhs" else ""
        print(f"  {workload} train step, bs 16, {base[workload].crop_size}^2, all kernels, traced: bfloat16 median "
              f"{b['step']:.2f} ms against float32 {f['step']:.2f} ms replayed, steps 3-{BF16_STEPS}, in this call (all: bf16 "
              f"{', '.join(f'{t:.2f}' for t in b['all'])}; f32 {', '.join(f'{t:.2f}' for t in f['all'])}){pre}; peak memory "
              f"{b['peak']:.2f} GiB against {f['peak']:.2f} GiB, on {card}")

    # one step from identical weights: every kernel against every plain implementation, in bf16
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for workload, cfg0 in base.items():
        results = {}
        for name, impls, fps_impl in (("kernels", {}, "auto"), ("plain", dict(chamfer_impl="jnp", bn_stats_impl="xla"), "plain")):
            cfg = dataclasses.replace(cfg0, compute_dtype="bfloat16", **impls)
            st = create_train_state(cfg, seed=0)
            batch = data[workload][1]
            if workload == "mmwhs":
                batch = make_device_preprocess(cfg, True, True, fps_impl=fps_impl)(torch.Generator(device=dev).manual_seed(11), batch)
            results[name] = {k: float(v) for k, v in make_train_step(cfg, st.models, st.optimizers)(st, batch)[1].items()}
            del st
        worst = {}
        for key, want in results["plain"].items():
            got = results["kernels"][key]
            _require(_bf16_tol_ok(key, got, want), f"bf16 {workload} step metric {key}: kernels {got} vs plain {want}")
            if not key.startswith("dis"):
                worst[key] = abs(got - want) / (STEP_ATOL + STEP_RTOL * abs(want))
        top = max(worst, key=worst.get)
        print(f"  one bf16 {workload} step, kernels vs plain from identical weights: {len(results['plain'])} metrics agree "
              f"(largest: {top} at {worst[top]:.2f}x the f32 step tolerance; allowed {BF16_STEP_SCALE}x, d4_loss "
              f"{BF16_D4_SCALE}x, accuracies 2 of 16 decisions; cuDNN deterministic)")
    torch.backends.cudnn.deterministic = False

    # the eval step
    cfg = dataclasses.replace(base["mscmrseg"], compute_dtype="bfloat16")
    state = create_train_state(cfg, seed=0)
    out = make_eval_step(cfg, state.models[0])(_to_device(torch, synthetic_eval_batch(cfg, cfg.bs), dev))
    logits = out["logits"]
    _require(tuple(logits.shape) == (16, 224, 224, 4) and logits.dtype == torch.float32 and bool(torch.isfinite(logits).all()),
             f"bf16 eval logits {tuple(logits.shape)} {logits.dtype}")
    vals = {k: float(out[k]) for k in ("loss", "dice", "vert_loss")}
    _require(all(np.isfinite(v) for v in vals.values()), f"bf16 eval metrics {vals}")
    print("  bf16 eval step: float32 logits (16, 224, 224, 4), " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
    del state

    # the reference's MS-CMRSeg command at the CLI's default dtype (bfloat16) and pipeline (heavy)
    steps = -(-RUN_NS // RUN_BS)
    val_batches = sum(-(-MS_SPLITS[s][2] // RUN_BS) for s in ("testA", "trainB_orig", "trainB"))
    want = {name: n * 2 * steps for name, n in per_step["mscmrseg"].items()}
    want["chamfer_forward"] += 2 * val_batches
    keep_bf16 = os.path.join(tmp, "best_bf16")
    os.makedirs(keep_bf16)
    _cli_training_run(torch, dev, rec, card, dict(
        path="mscmrseg_bf16_training_run", main=train_mscmrseg.main,
        argv=["-bs", str(RUN_BS), "-ns", str(RUN_NS), "-d1", "-d2", "-d4"],
        fabricate=lambda root: _fabricate_mscmrseg(root, seed=7), want=want,
        nets={"gen", "d1", "d2", "d4"}, files=("unet_model_checkpoint", "out_dis", "entropy_dis", "point_dis"),
        steps=steps, val_batches=val_batches, bit_equal=True, beside="phase (h)'s heavy and this phase's bf16",
        final_eval=None, keep=keep_bf16,
    ), (heavy_pre_ms, timing[("mscmrseg", "bfloat16")]["step"]))

    # the evaluate CLIs in bf16 on phase (j)'s patients: f32-trained generators against their f32 labels, the
    # untrained one, and the bf16-trained generator at both dtypes
    best_ms = [os.path.join(keep, f) for f in os.listdir(keep) if ".d1lr" in f][0]
    best_mm = [os.path.join(keep, f) for f in os.listdir(keep) if ".softmax" in f][0]
    best_bf16 = os.path.join(keep_bf16, os.listdir(keep_bf16)[0])
    lge_ids = list(LGE_TEST)
    lge = ["-data_dir", os.path.join(tmp, "lge"), "-klc", "-clahe", "-pat_lo", str(lge_ids[0]), "-pat_hi", str(lge_ids[-1] + 1)]
    dice_only = ["-d4", "-ifhd", "0", "-ifasd", "0"]
    _reset_launches()
    runs = (
        ("MS-CMRSeg, phase (i)'s generator", evaluate_mscmrseg.main, ["-model_dir", best_ms, "-from_name"] + lge, f32_labels["lge"], lge_ids),
        ("MS-CMRSeg, untrained generator (Dice only)", evaluate_mscmrseg.main,
         ["-model_dir", f32_labels["untrained"]] + dice_only + lge, f32_labels["lge_untrained"], lge_ids),
        ("MM-WHS, phase (g)'s generator", evaluate_mmwhs.main,
         ["-weight_dir", best_mm, "-from_name", "-data_dir", os.path.join(tmp, "ct")], f32_labels["ct"], CT_TEST),
    )
    for what, main, argv, f32_lab, ids in runs:
        with _eval_clock() as clock:
            result, text = _quiet(main, argv + ["-dtype", "bfloat16"])
        _require("Ave Dice:" in text and len(clock["labels"]) == len(f32_lab), f"{what}: no Ave Dice line or patients missing")
        _check_scores(result, what)
        shares = [_share(a, b) for a, b in zip(clock["labels"], f32_lab)]
        _require(max(shares) <= BF16_LABEL_SHARE, f"{what}: bf16 and f32 labels differ in {shares} of the voxels")
        print(_per_patient(clock, ids, card, f"{what}, -dtype bfloat16"))
        print(f"  {what}: bf16 labels against the f32 ones of phase (j), per patient "
              f"{', '.join(f'{v:.4%}' for v in shares)} of the voxels differ (allowed {BF16_LABEL_SHARE:.0%})")
    labels = {}
    for dtype in ("float32", "bfloat16"):
        with _eval_clock() as clock:
            result, _ = _quiet(evaluate_mscmrseg.main, ["-model_dir", best_bf16, "-from_name", "-dtype", dtype] + dice_only[1:] + lge)
        _check_scores(result, f"the bf16-trained generator evaluated in {dtype}")
        labels[dtype] = clock["labels"]
    shares = [_share(a, b) for a, b in zip(labels["bfloat16"], labels["float32"])]
    print(f"  phase (k)'s bf16-trained generator ({os.path.basename(best_bf16)}) evaluates in float32 and in bfloat16: "
          f"labels differ per patient in {', '.join(f'{v:.4%}' for v in shares)} of the voxels")
    counts = _launch_counts()
    _require(not any(counts.values()), f"kernels launched while evaluating in bf16: {counts}")
    _record_launches(rec, "evaluation_bf16", counts, set())
    print(f"  launches on the bf16 evaluation path: {counts}")


# phase (l): data parallelism on the one card. Two ranks share it over gloo
# (NCCL refuses two ranks on one device: "Duplicate GPU detected"); NCCL
# runs one rank through the command line. The two ranks and one process
# take the same global batches from the same weights, with cuDNN
# deterministic and TF32 off, He init (at the default init the generator's
# cloud collapses to a point and D4 normalises f32 noise; PERF.md, D4
# witness), SGD on the generator (Adam's first updates are lr * sign(g),
# which turns f32 noise in a gradient near 0 into +-lr: elementwise
# comparisons would hold noise) and no dropout in D4 (the witness below
# reorders the rows, and a mask follows its row; the global batch's masks
# are held on the CPU, tests/test_torch_port_parallel.py).
DP_WORLD, DP_STEPS = 2, 2
# Tolerances, two ranks against one process (float32; the global batch's
# sums in another order, as the kernels-vs-plain checks of this script
# meet): every metric of both steps at STEP_RTOL / STEP_ATOL, the
# accuracies within two flipped decisions of 16; the generator's, D1's and
# D2's parameters after both steps: each update (new - initial) within
# DP_UPDATE of its tensor's largest update plus two ulps (the SGD rule of
# tests/test_torch_port_step.py), BatchNorm running statistics rtol 1e-4,
# atol 1e-5. D4's updates are ill-conditioned in f32 (ROADMAP Queue 3: on a
# permuted batch, JAX against itself moves D4's gradients by up to 6%, and
# a tensor whose update is small, such as a norm's weight before the
# max-pool's near-ties, moves further): after the first step, D4 as a
# whole, its parameters and its running statistics apart, ||two ranks - one
# process|| <= DP_D4 ||one process - initial||. Beside each gap the
# WITNESS's is printed: the one process on the same global batch with its
# two halves swapped (the same function, its sums in another order).
# bfloat16: every metric at phase (k)'s bf16 tolerance, no parameter check.
DP_UPDATE, DP_D4 = 5e-2, 0.1
# the nets held, after the step that reads them
DP_HELD = {"gen": DP_STEPS, "d1": DP_STEPS, "d2": DP_STEPS, "d4": 1}


def _dp_config(workload: str, dtype: str):
    from pointcloududa_torch.config import mmwhs_default, mscmrseg_default

    common = dict(chamfer_impl="pallas", bn_stats_impl="pallas", compute_dtype=dtype, heinit=True, sgd=True, bs=16)
    if workload == "mscmrseg":
        return mscmrseg_default(d1=True, d2=True, d4=True, **common)
    return mmwhs_default(softmax=True, d2=True, d4=True, aug="light", **common)


def _dp_run(mesh, workload: str, dtype: str, swap: bool = False) -> dict:
    """``DP_STEPS`` train steps (MM-WHS: device preprocess + step) of one
    configuration at full width on the global synthetic batches of seeds
    0, 1, ...: on ``mesh``'s rows, or on the whole batch without a mesh
    (``swap``: with its halves swapped before the step). Returns the
    metrics, the kernels' launches and the all-reduces of each step, each
    step's ms, the peak memory, the states of ``DP_HELD``, and (MM-WHS) each
    call's clouds, and a profile of one more step."""
    import torch

    from pointcloududa_torch.data.synthetic import synthetic_batch, synthetic_raw_batch
    from pointcloududa_torch.parallel import collectives, replicate, shard_batch
    from pointcloududa_torch.train.loop import make_device_preprocess
    from pointcloududa_torch.train.state import create_train_state
    from pointcloududa_torch.train.step import make_train_step
    from pointcloududa_torch.utils.timing import event_ms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0) if mesh is None else mesh.device
    cfg = _dp_config(workload, dtype)
    state = replicate(create_train_state(cfg, seed=0, device=dev), mesh)
    state.models[3].dropout.p = 0.0
    step = make_train_step(cfg, state.models, state.optimizers, mesh=mesh)
    pre = make_device_preprocess(cfg, train=True, device_augment=True, device=dev, mesh=mesh) if workload == "mmwhs" else None
    gen, host = torch.Generator(device=dev).manual_seed(7), torch.Generator().manual_seed(9)
    make = synthetic_raw_batch if pre is not None else synthetic_batch
    order = torch.cat([torch.arange(cfg.bs // 2, cfg.bs), torch.arange(cfg.bs // 2)]).to(dev)

    def states(names):
        return {f"{n}.{k}": v.detach().float().cpu().numpy().copy() for n, m in zip(("gen", "d1", "d2", "d4"), state.models)
                if n in names and m is not None for k, v in m.state_dict().items()}

    out = dict(metrics=[], launches=[], all_reduces=[], ms=[], clouds=[], init=states(DP_HELD), held={})
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(DP_STEPS):
        raw = make(cfg, cfg.bs, seed=i)
        batch = shard_batch(raw, mesh) if mesh is not None else {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}
        torch.cuda.synchronize(dev)
        _reset_launches()
        collectives.reset_launches()

        def one_step(batch=batch):
            if pre is not None:
                batch = pre(gen, batch, host_generator=host)
            if swap:
                batch = {k: v[order] for k, v in batch.items()}
            return batch, step(state, batch)[1]

        # one process replays its second step; the ranks, under a mesh, run every step eagerly
        with _CardLaunches(torch) if mesh is None else contextlib.nullcontext() as launched:
            (batch, metrics), ms = event_ms(one_step)
        if pre is not None:
            out["clouds"].append({k: batch[k].cpu().numpy() for k in ("vert_s", "vert_t")})
        out["launches"].append(launched.counts if launched is not None else _launch_counts())
        out["all_reduces"].append(collectives.all_reduce.launches)
        out["ms"].append(ms)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["held"].update(states({n for n, s in DP_HELD.items() if s == i + 1}))
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if not swap:  # one more step, after everything above is read
        out["profile"] = _step_profile(torch, one_step)
    del state, step
    torch.cuda.empty_cache()
    return out


DP_RUNS = (("mscmrseg", "float32"), ("mscmrseg", "bfloat16"), ("mmwhs", "float32"))


def _dp_rank(mesh) -> dict:
    """What each rank of phase (l) runs (a top-level function: the ranks
    are spawned processes that import it)."""
    return {run: _dp_run(mesh, *run) for run in DP_RUNS}


def _dp_metrics(run, ranks, want, witness) -> str:
    """Every metric of every step on every rank against one process; returns
    the largest gaps as a share of the tolerance, the witness's beside."""
    workload, dtype = run
    worst = {"ranks": 0.0, "witness": 0.0}
    for name, runs in (("ranks", [rk[run] for rk in ranks]), ("witness", [witness] if witness else [])):
        for r, got in enumerate(runs):
            for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
                _require(set(g) == set(w), f"{run} {name} {r} step {i}: metric keys")
                for key, v in w.items():
                    if dtype == "bfloat16":
                        ok = _bf16_tol_ok(key, g[key], v)
                    elif key.startswith("dis"):
                        ok = abs(g[key] - v) <= 2.0 / 16
                    else:
                        ok = abs(g[key] - v) <= STEP_ATOL + STEP_RTOL * abs(v)
                        worst[name] = max(worst[name], abs(g[key] - v) / (STEP_ATOL + STEP_RTOL * abs(v)))
                    _require(ok or name == "witness", f"{run} rank {r} step {i} {key}: {g[key]} vs one process {v}")
    if dtype == "bfloat16":
        return "at phase (k)'s bf16 tolerance"
    return (f"largest gap {worst['ranks']:.3f} of the step tolerance (the witness, one process on the swapped batch: "
            f"{worst['witness']:.3f})")


def _dp_states(init: dict, got: dict, want: dict, witness: dict) -> str:
    """The parameter and buffer checks above, for the nets of ``DP_HELD``."""
    worst = 0.0
    d4 = {part: np.zeros(3) for part in ("parameters", "running statistics")}  # squared: update, ranks' gap, witness's gap
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            _require(np.array_equal(got[k], w), f"{k}: {got[k]} vs {w}")
        elif k.startswith("d4."):
            d4["running statistics" if "running" in k else "parameters"] += [
                float(np.sum(np.square(x - y, dtype=np.float64))) for x, y in ((w, init[k]), (got[k], w), (witness[k], w))]
        elif "running" in k:
            _require(np.allclose(got[k], w, rtol=1e-4, atol=1e-5), f"{k}: max |diff| {np.abs(got[k] - w).max()}")
        else:
            old = init[k].astype(np.float64)
            diff = np.abs(got[k] - w)
            tol = DP_UPDATE * np.abs(w - old).max() + 2 * np.spacing(np.abs(init[k]))
            _require(bool((diff <= tol).all()), f"update of {k} differs at {(diff > tol).sum()} of {diff.size} elements")
            worst = max(worst, float((diff / tol).max()))
    shares = []
    for part, (u, d, d_w) in d4.items():
        _require(np.sqrt(d) <= DP_D4 * np.sqrt(u), f"D4's {part}: |two ranks - one process| {np.sqrt(d):.3g} > {DP_D4} x "
                 f"|update| {np.sqrt(u):.3g}")
        shares.append(f"{part} {np.sqrt(d / u):.4f} (the witness {np.sqrt(d_w / u):.4f})")
    return (f"the generator's, D1's and D2's updates after {DP_STEPS} steps at {worst:.3f} of their tolerance, running "
            f"statistics within rtol 1e-4, atol 1e-5; D4 after 1 step within {', '.join(shares)} of its update's norm "
            f"(allowed {DP_D4})")


def phase_data_parallel(torch, dev, rec, card):
    """(l) data parallelism on the card: two gloo ranks against one process,
    MS-CMRSeg D1+D2+D4 (224^2, bs 16: 8 rows a rank) in float32 and bfloat16
    and the MM-WHS path (raw batch -> device preprocess -> step, softmax
    D2+D4, 256^2) in float32; then ``cli.train_mscmrseg.main -dist`` on one
    NCCL rank against the same command without ``-dist``."""
    from pointcloududa_torch.parallel import launch

    t0 = time.perf_counter()
    one = _dp_rank(None)
    witness = {run: _dp_run(None, *run, swap=True) for run in DP_RUNS if run[1] == "float32"}
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = launch.spawn(_dp_rank, [dev] * DP_WORLD, backend="gloo")
    ranks_s = time.perf_counter() - t0
    print(f"  one process and its witnesses: {one_s:.1f} s; {DP_WORLD} gloo ranks on the one card, spawned: {ranks_s:.1f} s "
          "(host time)")
    per_rank = [{} for _ in ranks]
    for run in DP_RUNS:
        workload, dtype = run
        want = one[run]
        cfg = _dp_config(workload, dtype)
        checked = _dp_metrics(run, ranks, want, witness.get(run))
        for r, got in enumerate(rk[run] for rk in ranks):
            lo, hi = r * cfg.bs // DP_WORLD, (r + 1) * cfg.bs // DP_WORLD
            for i, (g, w) in enumerate(zip(got["clouds"], want["clouds"])):
                for k in g:
                    _require(np.array_equal(g[k], w[k][lo:hi]), f"{run} rank {r} call {i}: {k} differs from one process's rows")
            for i, counts in enumerate(got["launches"]):
                _require(counts == want["launches"][i], f"{run} rank {r} step {i}: launches {counts} vs one process {want['launches'][i]}")
                for name, n in counts.items():
                    per_rank[r][name] = per_rank[r].get(name, 0) + n
        if dtype == "float32":
            held = ranks[0][run]["held"]
            _require(all(np.array_equal(v, ranks[1][run]["held"][k]) for k, v in held.items()), f"{run}: the ranks hold different states")
            checked += "; the ranks' states bit-equal to each other; " + _dp_states(want["init"], held, want["held"], witness[run]["held"])
            if workload == "mmwhs":
                checked += f"; the {2 * DP_STEPS} FPS clouds of each rank bit-equal to the one process's rows"
        print(f"  {workload} {dtype}: every metric of {DP_STEPS} steps on both ranks against one process, {checked}")
        step_ms = [statistics.median(rk[run]["ms"][1:]) for rk in ranks]
        print(f"  {workload} {dtype} {'preprocess + ' if workload == 'mmwhs' else ''}step, bs 16 = {DP_WORLD} x 8 rows, "
              f"{cfg.crop_size}^2: rank 0 {step_ms[0]:.2f} ms, rank 1 {step_ms[1]:.2f} ms (step {DP_STEPS}; all: "
              f"{', '.join(f'{t:.2f}' for rk in ranks for t in rk[run]['ms'])}), peak memory "
              f"{', '.join(f'{rk[run]['peak_gib']:.2f}' for rk in ranks)} GiB a rank, {ranks[0][run]['all_reduces'][-1]} "
              f"all-reduces a step over gloo; one process in this call: {statistics.median(want['ms'][1:]):.2f} ms "
              f"(all: {', '.join(f'{t:.2f}' for t in want['ms'])}), peak {want['peak_gib']:.2f} GiB; on {card}")
        print(f"    one more step profiled on rank 0: {_profile_text(ranks[0][run]['profile'])}")
        print(f"    and in one process: {_profile_text(want['profile'])}")
    expected = {"bn_stats_forward", "bn_stats_backward", "bn_stats_forward_bf16", "bn_stats_backward_bf16", "chamfer_forward",
                "chamfer_backward", "fps"}
    for r, counts in enumerate(per_rank):
        for name, n in counts.items():
            _require(n > 0 or name not in expected, f"rank {r} launched {name} no time")
    for name in per_rank[0]:
        entry = rec[name].setdefault("by_path", {}).setdefault("data_parallel", {})
        entry["launches"] = sum(c[name] for c in per_rank)
        entry["per_step_by_rank"] = {f"{w}_{d}": [rk[(w, d)]["launches"][-1][name] for rk in ranks] for w, d in DP_RUNS}
        rec[name]["launches"] = rec[name].get("launches", 0) + entry["launches"]
    print("  launches a step on each rank, equal to one process's: "
          + "; ".join(f"{w} {d}: {ranks[0][(w, d)]['launches'][-1]}" for w, d in DP_RUNS))
    _dp_cli(torch, dev, rec, card)


def _dp_cli(torch, dev, rec, card):
    """(l, cont.) ``cli.train_mscmrseg.main -dist`` with the launcher's
    environment of a world of one (NCCL, one rank: every collective runs, of
    one term) against the same command without ``-dist``, cuDNN
    deterministic: the logged records and every checkpointed tensor equal bit
    for bit."""
    from pointcloududa_torch.cli import train_mscmrseg
    from pointcloududa_torch.parallel import collectives, launch
    from pointcloududa_torch.train import checkpoint

    tmp = tempfile.mkdtemp(prefix="pcuda_smoke_dp_")
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(launch.free_port()), WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        _fabricate_mscmrseg(os.path.join(tmp, "data"), seed=7)
        argv = ["-bs", str(RUN_BS), "-ns", str(2 * RUN_BS), "-e", "1", "-d1", "-d2", "-d4", "-dtype", "float32",
                "-data_dir", os.path.join(tmp, "data")]
        counts = {}
        for tag, extra in (("dist", ["-dist"]), ("one", [])):
            os.environ.update(env)
            collectives.reset_launches()
            t0 = time.perf_counter()
            with _CardLaunches(torch) as launched:  # the run without -dist replays its second step
                _quiet(train_mscmrseg.main, argv + extra + ["-workdir", os.path.join(tmp, tag, "w"), "-logdir", os.path.join(tmp, tag, "r")])
            counts[tag] = (launched.counts, collectives.all_reduce.launches, time.perf_counter() - t0)
            _require(not torch.distributed.is_initialized(), "the CLI left its process group")
        _require(counts["dist"][0] == counts["one"][0], f"launches with -dist {counts['dist'][0]} vs without {counts['one'][0]}")
        _require(counts["dist"][1] > 0 and counts["one"][1] == 0, f"all-reduces: -dist {counts['dist'][1]}, without {counts['one'][1]}")
        expected = {k for k, v in counts["one"][0].items() if v}
        _require({"bn_stats_forward", "chamfer_forward"} <= expected, f"the run launched {counts['one'][0]}")
        _record_launches(rec, "data_parallel_nccl_cli", counts["dist"][0], expected)
        got, want = _read_scalars(os.path.join(tmp, "dist", "r")), _read_scalars(os.path.join(tmp, "one", "r"))
        _require(got == want and list(want) == [1], f"logged records differ: {got} vs {want}")
        files = sorted(os.listdir(os.path.join(tmp, "one", "w")))
        _require(files and sorted(os.listdir(os.path.join(tmp, "dist", "w"))) == files, "checkpoint files differ")
        n = 0
        for name in files:
            a, b = (checkpoint.restore_pytree(os.path.join(tmp, tag, "w", name)) for tag in ("dist", "one"))
            for key, v in b["state"]["net"]["model"].items():
                _require(torch.equal(a["state"]["net"]["model"][key], v), f"{name}: {key} differs")
                n += 1
        print(f"  cli.train_mscmrseg.main -dist, one NCCL rank (WORLD_SIZE=1), 1 epoch of 2 steps at bs {RUN_BS}, heavy "
              f"augmentation, D1+D2+D4: {len(want[1])} logged scalars and {n} tensors of {len(files)} checkpoints equal bit "
              f"for bit to the run without -dist ({counts['dist'][1]} all-reduces over NCCL; {counts['dist'][2]:.1f} s "
              f"against {counts['one'][2]:.1f} s host time); launches {counts['dist'][0]}, on {card}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(tmp, ignore_errors=True)


# phase (m): the host augmentation route. The heavy host batch of the
# determinism check, and the masks whose clouds are timed on the host
HOST_BATCH = (16, HEAVY_RAW, HEAVY_RAW, 3)
HOST_CLOUDS = 16


def _bf16_step_counts(per_step: dict) -> dict:
    """Phase (c)'s float32 launches a step, with the BatchNorm kernels in
    their bfloat16 rows: what a step at the CLI's default dtype launches."""
    out = dict(per_step)
    for name in ("bn_stats_forward", "bn_stats_backward"):
        out[f"{name}_bf16"], out[name] = out[name], 0
    return out


def _check_host_clouds(batches) -> int:
    """Every regenerated cloud of ``batches`` lies on the boundary voxels of
    its warped mask (the x3-stacked slab's, as ``data/pointcloud.py`` takes
    them), and a mask of at most 50 foreground pixels gives a zero cloud;
    returns the clouds checked."""
    from pointcloududa_torch.data.pointcloud import boundary_voxels

    n = 0
    for batch in batches:
        for m_key, v_key in (("mask_s", "vert_s"), ("mask_t", "vert_t")):
            _require(batch[v_key].dtype == np.float32 and batch[v_key].shape[1:] == (300, 3), f"{v_key} {batch[v_key].shape}")
            for mask, cloud in zip(batch[m_key], batch[v_key]):
                binary = np.asarray(mask).reshape(mask.shape[:2]) > 0
                if binary.sum() <= 50:
                    _require(not cloud.any(), "a mask of at most 50 pixels gave a cloud")
                else:
                    on = {tuple(p) for p in boundary_voxels(np.stack([binary] * 3))}
                    _require(all(tuple(p) in on for p in cloud.astype(np.int64)), f"a {v_key} point is off its mask's boundary")
                n += 1
    return n


def phase_host_route(torch, dev, rec, card, per_step, heavy_pre_step_ms, mmwhs_pre_step_ms):
    """(m) the host augmentation route at full width: ``cli.train_mscmrseg.main
    -host_aug`` and MM-WHS's ``build_mmwhs_pipelines(cfg,
    host_cloud_regen=True)`` with ``UDATrainer(device_augment=False)``."""
    from pointcloududa_torch.cli import train_mmwhs, train_mscmrseg
    from pointcloududa_torch.cli.common import resume_and_fit, with_kernels
    from pointcloududa_torch.data.build import build_mmwhs_pipelines
    from pointcloududa_torch.data.pointcloud import mask_to_point_cloud
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks
    from pointcloududa_torch.ops.host_augment import make_host_augment
    from pointcloududa_torch.train.loop import UDATrainer

    # one heavy host batch made twice from one seed: equal bit for bit on this host
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, HOST_BATCH, dtype=np.uint8)
    masks = synthetic_blob_masks(HOST_BATCH[0], HOST_BATCH[1], seed=3, n_class=4).astype(np.int64)
    hook = make_host_augment("heavy")
    t0 = time.perf_counter()
    first = hook(imgs, masks, np.random.default_rng(1))
    twin_s = time.perf_counter() - t0
    second = hook(imgs, masks, np.random.default_rng(1))
    _require(all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(first, second)),
             "one heavy host batch made twice from one seed differs")
    print(f"  one heavy host batch {HOST_BATCH} uint8, made twice from one seed: equal bit for bit; {twin_s:.3f} s on this "
          f"machine's host")

    # MS-CMRSeg: the reference's command with -host_aug, at the CLI's default dtype (bfloat16) and pipeline (heavy)
    steps = -(-RUN_NS // RUN_BS)
    val_batches = sum(-(-MS_SPLITS[s][2] // RUN_BS) for s in ("testA", "trainB_orig", "trainB"))
    want = {name: n * 2 * steps for name, n in _bf16_step_counts(per_step).items()}
    want["chamfer_forward"] += 2 * val_batches
    keep = tempfile.mkdtemp(prefix="pcuda_smoke_host_")
    try:
        _cli_training_run(torch, dev, rec, card, dict(
            path="host_augment", main=train_mscmrseg.main,
            argv=["-host_aug", "-bs", str(RUN_BS), "-ns", str(RUN_NS), "-d1", "-d2", "-d4"],
            fabricate=lambda root: _fabricate_mscmrseg(root, seed=7), want=want,
            nets={"gen", "d1", "d2", "d4"}, files=("unet_model_checkpoint", "out_dis", "entropy_dis", "point_dis"),
            steps=steps, val_batches=val_batches, bit_equal=False, beside="phase (h)'s heavy on the device (float32)",
            final_eval=None, keep=keep, resume=False,
        ), heavy_pre_step_ms)
        host = LOOP_MS["host_augment"]
        beside = [f"phase ({ph}) {LOOP_MS[path]['iteration_ms']:.2f} ms (waiting {LOOP_MS[path]['wait_ms']:.2f}, {what})"
                  for ph, path, what in (("k", "mscmrseg_bf16_training_run", "bf16"), ("i", "mscmrseg_training_run", "float32"))
                  if path in LOOP_MS]
        print(f"  heavy MS-CMRSeg iteration, host route (bf16) {host['iteration_ms']:.2f} ms (waiting for batches "
              f"{host['wait_ms']:.2f}); the device route: {'; '.join(beside) or 'not run'}; epoch 2 of each, on {card}")

        # MM-WHS: host cloud regeneration through the Python API (the MM-WHS CLI has no flag for it)
        seen = []

        def host_regen_main(argv):
            args = train_mmwhs.build_parser().parse_args(argv)
            cfg = with_kernels(train_mmwhs.config_from_args(args))
            print(train_mmwhs.appendix(cfg))
            train_iter, val_iters, device_augment = build_mmwhs_pipelines(cfg, workers=args.workers, host_cloud_regen=True)
            _require(device_augment is False, "host_cloud_regen=True must turn the device augmentation off")
            epoch = train_iter.epoch

            def watched():
                for i, batch in enumerate(epoch()):
                    if i == 0:
                        seen.append(batch)
                    yield batch

            train_iter.epoch = watched
            trainer = UDATrainer(cfg, train_iter, val_iters, workdir=args.workdir, logdir=args.logdir,
                                 device_augment=device_augment)
            resume_and_fit(trainer, args)

        cadence_steps = -(-steps // RUN_VERT_T_EVERY)
        mm_val = sum(-(-RUN_SLICES[s] // RUN_BS) for s in ("mr_val", "ct_val", "ct_train"))
        _cli_training_run(torch, dev, rec, card, dict(
            path="host_cloud_regen", main=host_regen_main,
            argv=["-bs", str(RUN_BS), "-ns", str(RUN_NS), "-nf", "32", "-aug", "light", "-softmax", "-d2", "-d4",
                  "-vert_t_every", str(RUN_VERT_T_EVERY), "-dtype", "float32"], final_eval=None, keep=keep, resume=False,
            fabricate=lambda root: _fabricate_mmwhs(root, seed=5, ct_test=False),
            want={
                "fps": 0,
                "chamfer_forward": 2 * (steps + cadence_steps + mm_val),
                "chamfer_nn_forward": 0,
                "chamfer_backward": 2 * steps,
                "bn_stats_forward": 2 * steps * 32,
                "bn_stats_backward": 2 * steps * 32,
                "bn_stats_forward_bf16": 0,
                "bn_stats_backward_bf16": 0,
            },
            nets={"gen", "d2", "d4"}, files=("unet_model_checkpoint", "entropy_dis", "point_dis"),
            steps=steps, val_batches=mm_val, bit_equal=False, beside="phase (f)'s device route (light, FPS clouds)",
        ), mmwhs_pre_step_ms)
        _require(len(seen) == 2, f"{len(seen)} first batches seen, not one an epoch")
        n = _check_host_clouds(seen)
        print(f"  {n} regenerated clouds of the epochs' first batches lie on their warped masks' boundary voxels")
        regen = LOOP_MS["host_cloud_regen"]
        print(f"  MM-WHS host-regeneration iteration with the host library's clouds: {regen['iteration_ms']:.2f} ms (waiting for "
              f"batches {regen['wait_ms']:.2f}), on {card}; with numpy clouds: {NUMPY_REGEN_ITERATION_MS} ms (NVIDIA H100 80GB "
              f"HBM3, 700 W)")
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    # the host's time a cloud, and the zero cloud of a small mask
    blobs = synthetic_blob_masks(HOST_CLOUDS, HEAVY_RAW, seed=5)
    np.random.seed(0)
    t0 = time.perf_counter()
    clouds = [mask_to_point_cloud(m) for m in blobs]
    per_cloud = (time.perf_counter() - t0) / HOST_CLOUDS * 1e3
    _require(all(c.shape == (300, 3) and c.any() for c in clouds), "a fabricated mask gave no cloud")
    small = np.zeros((HEAVY_RAW, HEAVY_RAW), np.uint8)
    small[100:105, 100:110] = 1  # 50 pixels: at the threshold
    _require(not mask_to_point_cloud(small).any(), "a mask of 50 pixels gave a cloud")
    fps_ms = rec["fps"].get("ms")
    print(f"  host cloud regeneration: {per_cloud:.2f} ms a cloud ({HOST_CLOUDS} masks of {HEAVY_RAW}^2, the host library) on this "
          f"machine's host, {2 * RUN_BS * per_cloud:.0f} ms for a step's {2 * RUN_BS}; the FPS kernel (phase (e)): "
          f"{fps_ms:.4f} ms for 16 clouds, on {card}; a 50-pixel mask gives the zero cloud")


# phase (n): the reproduction runbooks (prep/reproduce.py, prep/reproduce_mmwhs.py)
# on the card at full width, from raw data. MS-CMRSeg: raw patients, (X, Y, Z)
# as the nii stores them, 256^2 x 12 and one at 480^2 x 12 (the nearest
# resize); patients 1-3 train on bSSFP, 4 validates, 1-4 are the LGE target
# and its evaluation. MM-WHS: REPRO_SLICES TFRecords of the release's
# 256 x 256 x 3 float32 records a split, and phase (g)'s four CT test
# volumes. The paper rows' flags are kept; only -ns and -e are cut, to 2
# epochs of REPRO_NS // 16 steps at bs 16. The host library's clouds are held
# bit-equal to the numpy plain versions on REPRO_CLOUDS of the masks the
# runbooks made; the plain version is timed on REPRO_PLAIN_TIMED of them.
REPRO_PATIENTS = {1: (256, 256, 12), 2: (256, 256, 12), 3: (256, 256, 12), 4: (480, 480, 12)}
REPRO_SLICES = 32
REPRO_NS, REPRO_EPOCHS = 64, 2
REPRO_CLOUDS, REPRO_PLAIN_TIMED = 64, 8
MS_PAPER_ROW = ["-aug2", "-d1", "-d2", "-d4"]  # the D1+D2+D4 row of the MS-CMRSeg table: every kernel of the step
# phase (m)'s MM-WHS host-regeneration iteration with the numpy clouds that the
# host library replaced: ms, from this script's run on an NVIDIA H100 80GB
# HBM3 at 700 W before the library (numpy's 204.58-245.08 ms a cloud)
NUMPY_REGEN_ITERATION_MS = 8281.63


def _fabricate_raw_mscmrseg(root: str, seed: int) -> int:
    """The raw MS-CMRSeg layout of ``prep/reproduce.py``: int16 NIfTI images
    (noise over brighter structures) and labels in the raw values {0, 200,
    500, 600} for bSSFP (``labels/``) and LGE (``labels/lge_test_gt/``),
    written by the port's ``save_nii``; returns the slices per modality."""
    from pointcloududa_torch.utils.nifti import save_nii

    rng = np.random.default_rng(seed)
    raw = np.array([0, 200, 500, 600], np.int16)
    d = lambda *p: os.path.join(root, "raw_data", *p)  # noqa: E731
    for sub in ("dataset", os.path.join("labels", "lge_test_gt")):
        os.makedirs(d(sub), exist_ok=True)
    for pat, (x, y, z) in REPRO_PATIENTS.items():
        for tag, gt in (("C0", d("labels", f"patient{pat}_C0_manual.nii.gz")),
                        ("LGE", d("labels", "lge_test_gt", f"patient{pat}_LGE_manual.nii.gz"))):
            labels = _ellipsoids((z, y, x), 3, rng)  # (Z, Y, X)
            img = rng.normal(300.0, 60.0, labels.shape) + 150.0 * labels
            save_nii(d("dataset", f"patient{pat}_{tag}.nii.gz"), img.astype(np.int16).T)
            save_nii(gt, raw[labels].T)
    return sum(z for _, _, z in REPRO_PATIENTS.values())


def _fabricate_raw_mmwhs(root: str, seed: int) -> int:
    """The raw PnP-AdaNet layout of ``prep/reproduce_mmwhs.py``: per split
    REPRO_SLICES TFRecords of 256 x 256 x 3 float32 ``data_vol`` / ``label_vol``
    (labels 0-4, repeated over the 3 channels), written by the port's
    ``utils/tfrecord.py``, the datalists, and phase (g)'s CT test volumes;
    returns the slices written."""
    from pointcloududa_torch.data.manifest import write_ids
    from pointcloududa_torch.data.synthetic import synthetic_blob_masks
    from pointcloududa_torch.utils.tfrecord import write_example, write_tfrecord

    rng = np.random.default_rng(seed)
    for j, split in enumerate(("ct_train", "ct_val", "mr_train", "mr_val")):
        tf_dir = os.path.join(root, "PnpAda_release_data", "train_n_val", f"{split}_tfs")
        os.makedirs(tf_dir)
        ids = [f"{split}_slice{i}.tfrecords" for i in range(REPRO_SLICES)]
        for _id, mask in zip(ids, synthetic_blob_masks(REPRO_SLICES, 256, seed=seed + 1 + j)):
            img = rng.normal(size=(256, 256, 3)).astype("<f4") * 0.5 + mask[..., None].astype("<f4") * 0.5
            lab = np.repeat(mask[..., None], 3, -1).astype("<f4")
            write_tfrecord(os.path.join(tf_dir, _id), [write_example({"data_vol": img.tobytes(), "label_vol": lab.tobytes()})])
        write_ids(os.path.join(root, f"{split}_list.csv"), ids)
    return 4 * REPRO_SLICES + _fabricate_ct_test(root, seed)


def _drive_runbook(runbook, run, stage_s, counts_of):
    """``run()``, which drives ``runbook``'s stages through its ``run_stage``
    on the card, with each stage timed into ``stage_s`` and the kernels'
    launches of each CLI stage on the card into ``counts_of``;
    returns what the stages printed."""
    real = runbook.run_stage

    def timed(module, stage_argv, workdir, device=None):
        import torch

        name = module.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        with _CardLaunches(torch) if module.startswith(runbook.CLI) else contextlib.nullcontext() as launched:
            real(module, stage_argv, workdir, device=device)
        stage_s.append((name, time.perf_counter() - t0))
        if launched is not None:
            counts_of[name] = launched.counts

    runbook.run_stage = timed
    try:
        return _quiet(run)[1]
    finally:
        runbook.run_stage = real


def _csv_rows(path: str) -> list:
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def _check_metric_rows(rows, n: int, what: str, means: bool = False) -> None:
    """``n`` rows of a per-patient CSV whose metrics are finite and >= 0 or the
    -1 sentinel of an empty structure; ``means``: each is a mean over
    structures, which may mix the sentinel in, so only finite."""
    _require(len(rows) == n, f"{what}: {len(rows)} rows, not {n}")
    for row in rows:
        for key in ("DC", "HD", "ASD") if means else ("DSC", "HD", "ASD"):
            v = float(row[key])
            _require(np.isfinite(v) and (means or v >= 0 or v == -1), f"{what}: {key}={row[key]} is neither >= 0 nor -1")


def _clouds_native_and_plain(masks) -> tuple:
    """Every mask's cloud from the host library and from the numpy plain
    versions, from the same seeds: equal bit for bit. Returns the ms a cloud
    of each on this machine's host (the plain version over the first
    REPRO_PLAIN_TIMED masks; the rest run four at a time, untimed)."""
    from pointcloududa_torch.data import pointcloud as pc

    def plain(i):
        binary = (np.asarray(masks[i]) > 0).astype(np.uint8)
        if binary.sum() <= 50:
            return np.zeros((300, 3))
        pts = pc.boundary_voxels_plain(np.stack([binary] * 3)).astype(np.float64)
        return np.asarray(pc.farthest_point_sampling_plain(pts, 300, seed=i), np.int64).astype(np.float64)

    t0 = time.perf_counter()
    native = [pc.mask_to_point_cloud(m, seed=i) for i, m in enumerate(masks)]
    native_ms = (time.perf_counter() - t0) / len(masks) * 1e3
    t0 = time.perf_counter()
    plains = [plain(i) for i in range(REPRO_PLAIN_TIMED)]
    plain_ms = (time.perf_counter() - t0) / REPRO_PLAIN_TIMED * 1e3
    with ThreadPoolExecutor(4) as pool:
        plains += list(pool.map(plain, range(REPRO_PLAIN_TIMED, len(masks))))
    for i, (a, b) in enumerate(zip(native, plains)):
        _require(a.shape == (300, 3) and np.array_equal(a, b), f"mask {i}: the host library's cloud is not the plain one")
    _require(sum(bool(a.any()) for a in native) >= len(masks) // 2, "most of the made masks gave no cloud")
    return native_ms, plain_ms


def phase_reproduce(torch, dev, rec, card, per_step):
    """(n) both reproduction runbooks through their ``main``, every stage, on
    fabricated raw data in a temporary directory."""
    from pointcloududa_torch.data.manifest import load_ids
    from pointcloududa_torch.prep import reproduce, reproduce_mmwhs
    from pointcloududa_torch.prep.runbook import drive
    from pointcloududa_torch.utils.png import IMREAD_GRAYSCALE, read_png

    tmp = tempfile.mkdtemp(prefix="pcuda_smoke_repro_")
    steps = -(-REPRO_NS // 16)
    zero = {name: 0 for name in KERNELS}
    try:
        # MS-CMRSeg: NIfTI -> PNGs, datalists, clouds, _r1/_r2, the D1+D2+D4 row (-aug2, bfloat16), evaluation with -klc
        root, work = os.path.join(tmp, "input_aug"), os.path.join(tmp, "weights_ms")
        t0 = time.perf_counter()
        n = _fabricate_raw_mscmrseg(root, seed=11)
        print(f"  MS-CMRSeg: fabricated {len(REPRO_PATIENTS)} raw patients ({n} slices a modality; "
              f"{', '.join(f'{p}: {s}' for p, s in REPRO_PATIENTS.items())}) in {time.perf_counter() - t0:.1f} s")
        stage_s, counts = [], {}
        # the runbook's stages for these patients (its command line takes the release's 45), driven as its main drives them;
        # the later -ns overrides the stage's own
        stages = reproduce.build_stages(root, work, pats=(1, 5), val_pats=(4, 5), eval_pats=(1, 5),
                                        train_args=MS_PAPER_ROW + ["-ns", str(REPRO_NS)], epochs=REPRO_EPOCHS)
        _drive_runbook(reproduce, lambda: drive(stages, reproduce.run_stage, work), stage_s, counts)
        _require(len(stage_s) == len(stages) == 20, f"{len(stage_s)} of {len(stages)} stages ran")
        ids = {csv: load_ids(os.path.join(root, f"{csv}.csv")) for csv in ("aug_trainA", "testA", "aug_trainB", "testB")}
        for split, sub in (("aug_trainA", "trainA"), ("aug_trainB", "trainB")):
            base = [i for i in ids[split] if not i.endswith(("_r1", "_r2"))]
            _require(len(ids[split]) == 3 * len(base) and {f"{i}_{r}" for i in base for r in ("r1", "r2")} <= set(ids[split]),
                     f"{split}: the _r1/_r2 ids are missing")
            for _id in ids[split]:
                for path in (os.path.join(root, "processed", sub, f"{_id}.png"), os.path.join(root, "processed", sub + "mask", f"{_id}.png"),
                             os.path.join(root, "vertices", sub, f"{_id}.npy")):
                    _require(os.path.isfile(path), f"missing artifact {path}")
        val_batches = sum(-(-len(ids[c]) // 16) for c in ("testA", "testB", "aug_trainB"))
        want = {name: k * REPRO_EPOCHS * steps for name, k in _bf16_step_counts(per_step).items()}
        want["chamfer_forward"] += REPRO_EPOCHS * val_batches
        _require(counts["train_mscmrseg"] == want, f"MS-CMRSeg train stage launches {counts['train_mscmrseg']}, derived {want}")
        _require(counts["evaluate_mscmrseg"] == zero, f"MS-CMRSeg evaluate stage launched {counts['evaluate_mscmrseg']}")
        _record_launches(rec, "reproduce_mscmrseg", counts["train_mscmrseg"], {k for k, v in want.items() if v})
        _record_launches(rec, "reproduce_mscmrseg_evaluate", counts["evaluate_mscmrseg"], set())
        rows = _csv_rows(os.path.join(work, "per_patient.csv"))
        _check_metric_rows(rows, 3 * len(REPRO_PATIENTS), "MS-CMRSeg per_patient.csv")
        ms_masks = [read_png(os.path.join(root, "processed", "trainBmask", f"{i}.png"), IMREAD_GRAYSCALE)
                    for i in ids["aug_trainB"][: REPRO_CLOUDS // 2]]
        print(f"  MS-CMRSeg stages, s: " + ", ".join(f"{name} {s:.2f}" for name, s in stage_s))
        print(f"  ids: trainA {len(ids['aug_trainA'])}, trainB {len(ids['aug_trainB'])} with _r1/_r2, testA {len(ids['testA'])}, "
              f"testB {len(ids['testB'])}; launches of the train stage ({REPRO_EPOCHS} epochs of {steps} steps, {val_batches} "
              f"validation batches an epoch): {counts['train_mscmrseg']}, as derived; the evaluate stage: 0; "
              f"{len(rows)} per-patient rows, finite or -1")

        # MM-WHS: TFRecords -> npy, clouds, the paper's command with -aug light (FPS on the card), its final
        # evaluation, then the evaluate stage on the four CT volumes
        root, work = os.path.join(tmp, "input"), os.path.join(tmp, "weights_mm")
        t0 = time.perf_counter()
        n = _fabricate_raw_mmwhs(root, seed=13)
        print(f"  MM-WHS: fabricated {n} slices ({REPRO_SLICES} TFRecords a split, {len(CT_TEST)} CT volumes) in "
              f"{time.perf_counter() - t0:.1f} s")
        stage_s, counts = [], {}
        train_args = reproduce_mmwhs.PAPER_TRAIN + ["-aug", "light", "-ns", str(REPRO_NS), "-e", str(REPRO_EPOCHS)]
        argv = ["--data-root", root, "--workdir", work, "--train-args", " ".join(train_args)]
        text = _drive_runbook(reproduce_mmwhs, lambda: reproduce_mmwhs.main(argv), stage_s, counts)
        _require(len(stage_s) == 7, f"{len(stage_s)} of 7 stages ran")
        _require(text.count("Ave Dice:") == 2, "the train stage's final evaluation or the evaluate stage did not report")
        mm_masks = []
        for split in ("ct_train", "ct_val", "mr_train", "mr_val"):
            base = os.path.join(root, "PnpAda_release_data", split)
            split_ids = load_ids(os.path.join(root, f"{split}_list.csv"))
            for _id in split_ids:
                for sub in ("img", "mask", "vertices"):
                    _require(os.path.isfile(os.path.join(base, sub, f"{_id}.npy")), f"missing artifact {split}/{sub}/{_id}.npy")
            mm_masks += [np.load(os.path.join(base, "mask", f"{_id}.npy"))[..., 0] for _id in split_ids[: REPRO_CLOUDS // 8]]
        cadence = steps  # vert_t_every 1: the target cloud and its metric every step
        mm_val = 3 * -(-REPRO_SLICES // 16)
        want = {name: 0 for name in KERNELS}
        want.update(fps=REPRO_EPOCHS * (steps + cadence), chamfer_forward=REPRO_EPOCHS * (steps + cadence + mm_val),
                    chamfer_backward=REPRO_EPOCHS * steps, bn_stats_forward_bf16=REPRO_EPOCHS * steps * 32,
                    bn_stats_backward_bf16=REPRO_EPOCHS * steps * 32)
        _require(counts["train_mmwhs"] == want, f"MM-WHS train stage launches {counts['train_mmwhs']}, derived {want}")
        _require(counts["evaluate_mmwhs"] == zero, f"MM-WHS evaluate stage launched {counts['evaluate_mmwhs']}")
        _record_launches(rec, "reproduce_mmwhs", counts["train_mmwhs"], {k for k, v in want.items() if v})
        _record_launches(rec, "reproduce_mmwhs_evaluate", counts["evaluate_mmwhs"], set())
        rows = _csv_rows(os.path.join(work, "per_patient.csv"))
        _check_metric_rows(rows, len(CT_TEST), "MM-WHS per_patient.csv", means=True)
        print(f"  MM-WHS stages, s: " + ", ".join(f"{name} {s:.2f}" for name, s in stage_s))
        print(f"  launches of the train stage ({REPRO_EPOCHS} epochs of {steps} steps, {mm_val} validation batches an epoch, "
              f"then its final evaluation): {counts['train_mmwhs']}, as derived; the evaluate stage: 0; {len(rows)} per-patient "
              f"rows, finite")

        native_ms, plain_ms = _clouds_native_and_plain(ms_masks + mm_masks)
        print(f"  host clouds: {len(ms_masks) + len(mm_masks)} of the made masks ({len(ms_masks)} MS-CMRSeg 224^2 PNGs, "
              f"{len(mm_masks)} MM-WHS 256^2) bit-equal to the numpy plain versions; the host library {native_ms:.2f} ms a cloud, "
              f"numpy {plain_ms:.2f} ms ({plain_ms / native_ms:.1f}x), on this machine's host ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase (o): the smokes' step counts and probe cadence, from which their
# launches are derived (the smokes' own defaults)
SMOKE_TRAIN_STEPS, SMOKE_UDA_STEPS, SMOKE_UDA_EVERY = 80, 150, 25


def _generator_batchnorms(cfg) -> int:
    """The BatchNorms of ``cfg``'s generator, counted on a CPU build."""
    from pointcloududa_torch.models.unet import TwinBatchNorm
    from pointcloududa_torch.train.state import build_generator

    return sum(isinstance(m, TwinBatchNorm) for m in build_generator(cfg).modules())


def _step_launches(cfg, steps: int, evals_with_cloud: int = 0) -> dict:
    """What ``steps`` train steps of ``cfg`` through the kernels launch: a
    forward of each generator BatchNorm on the source and on the target
    batch, a backward on the source and, where an adversary trains the
    generator on the target, on the target too; where the point head is on,
    the Chamfer loss and the logged target Chamfer (two fused forwards) and
    one backward a step, and one fused forward an evaluation batch with a
    cloud. Training rows in the compute dtype; evaluation normalises with
    the running statistics."""
    nb = _generator_batchnorms(cfg)
    suffix = "_bf16" if cfg.compute_dtype == "bfloat16" else ""
    want = {name: 0 for name in KERNELS}
    want["bn_stats_forward" + suffix] = steps * 2 * nb
    want["bn_stats_backward" + suffix] = steps * nb * (2 if (cfg.d1 or cfg.d2 or cfg.d4) else 1)
    if cfg.point_head:
        want["chamfer_forward"] = 2 * steps + evals_with_cloud
        want["chamfer_backward"] = steps
    return want


def phase_smokes(torch, dev, rec, card):
    """(o) the convergence smokes through their ``main`` at their defaults."""
    from pointcloududa_torch.cli.common import with_kernels
    from pointcloududa_torch.config import mscmrseg_default
    from pointcloududa_torch.smoke import smoke_train, smoke_uda

    t0 = time.perf_counter()
    with _CardLaunches(torch) as launched:
        launched.every()
        dices = smoke_train.main([])
    train_s = time.perf_counter() - t0
    counts = launched.counts
    cfg = with_kernels(mscmrseg_default(bs=16, compute_dtype="bfloat16"))
    want = _step_launches(cfg, SMOKE_TRAIN_STEPS)
    _require(counts == want, f"smoke_train launched {counts}, derived {want}")
    _require(dices[-1][0] == SMOKE_TRAIN_STEPS - 1 and dices[-1][1] >= 0.85, f"smoke_train's last Dice {dices[-1]}")
    _record_launches(rec, "smoke_train", counts, {k for k, v in want.items() if v})
    print(f"  smoke_train (bs 16, 224^2, nf 32, bf16, {SMOKE_TRAIN_STEPS} steps): Dice by step "
          + ", ".join(f"{i} {d:.4f}" for i, d in dices)
          + f"; {train_s:.1f} s, {SMOKE_TRAIN_STEPS * 16 / train_s:.0f} slices/s with the host's batches and the state's "
          f"creation, traced in {launched.traces} traces; launches on the card {counts}, as derived; on {card}")

    t0 = time.perf_counter()
    with _CardLaunches(torch) as launched:
        launched.every()  # more steps than one trace holds
        probes = smoke_uda.main(["--d4"])
    uda_s = time.perf_counter() - t0
    counts = launched.counts
    cfg = with_kernels(mscmrseg_default(bs=16, d1=True, d2=True, d4=True, compute_dtype="bfloat16"))
    n_probes = len(range(0, SMOKE_UDA_STEPS, SMOKE_UDA_EVERY)) + ((SMOKE_UDA_STEPS - 1) % SMOKE_UDA_EVERY > 0)
    want = _step_launches(cfg, SMOKE_UDA_STEPS, evals_with_cloud=n_probes)
    _require(counts == want, f"smoke_uda launched {counts}, derived {want}")
    _require(len(probes) == n_probes and all(np.isfinite(v) for p in probes for v in p.values()), "smoke_uda's probes")
    _require(probes[-1]["seg_dice"] >= 0.5, f"smoke_uda's last source Dice {probes[-1]['seg_dice']}")
    _record_launches(rec, "smoke_uda", counts, {k for k, v in want.items() if v})
    for p in probes:
        print(f"  smoke_uda step {p['step']:3d}: src_dice {p['seg_dice']:.4f} tgt_dice {p['tgt_dice']:.4f} seg_loss "
              f"{p['seg_loss']:.4f} adv {p['adv_loss']:.4f} d1 {p['dis1_acc1']:.2f}/{p['dis1_acc2']:.2f} "
              f"d2 {p['dis2_acc1']:.2f}/{p['dis2_acc2']:.2f} d4 {p['dis4_acc1']:.2f}/{p['dis4_acc2']:.2f}")
    print(f"  smoke_uda --d4 (bs 16, 224^2, bf16, D1+D2+D4, pool 12, {SMOKE_UDA_STEPS} steps): {uda_s:.1f} s with the "
          f"pool's 384 host clouds, traced in {launched.traces} traces; launches on the card {counts}, as derived; on {card}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on an NVIDIA GPU", file=sys.stderr)
        return 1
    from pointcloududa_torch.utils import host_native, native

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
    with ThreadPoolExecutor(1) as pool:  # g++ builds the host library while nvcc builds the kernels
        host = pool.submit(lambda: (host_native.load(), time.perf_counter() - t0)[1])
        native.load()
        print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s: {native.library_path()}")
        print(f"host library built and loaded in {host.result():.2f} s: {host_native.library_path()}")
    usage = [ln.strip() for ln in native.build_log.splitlines() if any(k in ln for k in ("registers", "Compiling entry", "spill"))]
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
    cfg, per_step = phase_train_step(torch, dev, rec, smi)
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
    pre_step_ms = phase_mmwhs(torch, dev, rec, smi)
    seconds["f"] = time.perf_counter() - t0
    keep = tempfile.mkdtemp(prefix="pcuda_smoke_best_")  # the best generators of (g) and (i), evaluated in (j) and (k)
    tests = tempfile.mkdtemp(prefix="pcuda_smoke_eval_")  # the test patients of (j), read again in (k)
    try:
        print("(g) the training run: fabricated MM-WHS dataset -> cli.train_mmwhs.main (train, validate, checkpoint, "
              "evaluate the best, resume)")
        t0 = time.perf_counter()
        final_eval = phase_training_run(torch, dev, rec, smi, pre_step_ms, keep)
        seconds["g"] = time.perf_counter() - t0
        print("(h) the heavy and medium pipelines: MS-CMRSeg and MM-WHS raw batch -> device preprocess -> train step")
        t0 = time.perf_counter()
        heavy_pre_step_ms = phase_heavy(torch, dev, rec, smi, per_step)
        seconds["h"] = time.perf_counter() - t0
        print("(i) the MS-CMRSeg training run: fabricated PNG dataset -> cli.train_mscmrseg.main without -aug (heavy), resume")
        t0 = time.perf_counter()
        phase_mscmrseg_run(torch, dev, rec, smi, per_step, heavy_pre_step_ms, keep)
        seconds["i"] = time.perf_counter() - t0
        print("(j) evaluation: the evaluate CLIs on fabricated test patients, the predictor and its export")
        t0 = time.perf_counter()
        f32_labels = phase_evaluation(torch, dev, rec, smi, keep, final_eval, tests)
        seconds["j"] = time.perf_counter() - t0
        print("(k) bfloat16: both steps beside float32, kernels vs plain, the eval step, cli.train_mscmrseg.main at its "
              "default dtype with resume, both evaluate CLIs with -dtype bfloat16")
        t0 = time.perf_counter()
        phase_bf16(torch, dev, rec, smi, heavy_pre_step_ms[0], keep, tests, f32_labels)
        seconds["k"] = time.perf_counter() - t0
        print("(l) data parallelism: two gloo ranks on the card against one process (MS-CMRSeg float32 and bfloat16, "
              "the MM-WHS path), then cli.train_mscmrseg.main -dist on one NCCL rank")
        t0 = time.perf_counter()
        phase_data_parallel(torch, dev, rec, smi)
        seconds["l"] = time.perf_counter() - t0
        print("(m) the host augmentation route: cli.train_mscmrseg.main -host_aug (bfloat16, heavy) and MM-WHS with host "
              "cloud regeneration (build_mmwhs_pipelines(host_cloud_regen=True), UDATrainer(device_augment=False))")
        t0 = time.perf_counter()
        phase_host_route(torch, dev, rec, smi, per_step, heavy_pre_step_ms, pre_step_ms)
        seconds["m"] = time.perf_counter() - t0
        print("(n) the reproduction runbooks from raw data: prep/reproduce.py (MS-CMRSeg NIfTI, -aug2 -d1 -d2 -d4, evaluation "
              "with -klc) and prep/reproduce_mmwhs.py (TFRecords, the paper's command with -aug light), every stage")
        t0 = time.perf_counter()
        phase_reproduce(torch, dev, rec, smi, per_step)
        seconds["n"] = time.perf_counter() - t0
        print(f"  phase (n): {seconds['n']:.1f} s")
        print("(o) the convergence smokes: smoke_train (80 steps, bs 16, 224^2, bf16) and smoke_uda --d4 (150 steps)")
        t0 = time.perf_counter()
        phase_smokes(torch, dev, rec, smi)
        seconds["o"] = time.perf_counter() - t0
        print(f"  phase (o): {seconds['o']:.1f} s")
    finally:
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(tests, ignore_errors=True)
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
