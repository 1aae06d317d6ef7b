"""Paired source/target loader with worker-pool decode and device prefetch
(counterpart of the JAX package's ``data/loader.py``).

Replaces the reference's synchronous ``for ... in zip(trainA, trainB)`` host
loop with per-step H2D copies (``src/train_mscmrseg.py:183,201,219``, the
documented hot-loop bottleneck, SURVEY.md §3.1):

  sampler (ring indices) -> worker pool (decode) -> assembled numpy batch
  (-> host augmentation and cloud regeneration, optional) -> background
  prefetch thread -> copy to the card one batch ahead of compute.

Device-side augmentation (``ops/augment.py``, ``ops/pointcloud_device.py``)
is the default fast path: the loader then ships raw uint8/f32 arrays. The
host route (``BatchAssembler(host_augment=ops.host_augment.make_host_augment
(aug), regen_vertices=...)``) augments each assembled batch with the numpy
twin and can regenerate the clouds from the warped masks
(``data/pointcloud.py``); the assembler runs in the prefetch thread.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from pointcloududa_torch.data.pointcloud import mask_to_point_cloud
from pointcloududa_torch.data.sampler import RingSampler
from pointcloududa_torch.parallel import pad_batch
from pointcloududa_torch.utils.timer import QUEUE_WAIT, trace_annotation


class BatchAssembler:
    """Decodes a list of indices into one batch dict via a thread pool
    (zlib and np.load release the GIL).

    ``host_augment(images, masks, rng) -> (images, masks)`` augments the
    assembled batch with the caller's numpy ``rng``; with ``regen_vertices``
    the clouds are then rebuilt from the augmented masks (float32, on the
    0..255 voxel grid; the start of each cloud's FPS is a draw from numpy's
    global generator, as in the JAX package)."""

    def __init__(self, adapter, workers: int = 4, host_augment: Optional[Callable] = None,
                 regen_vertices: bool = False):
        self._adapter = adapter
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        self._host_augment = host_augment
        self._regen = regen_vertices

    def __call__(self, indices, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        if self._pool is not None:
            records = list(self._pool.map(self._adapter, indices))
        else:
            records = [self._adapter(i) for i in indices]
        imgs = np.stack([r[0] for r in records])
        masks = np.stack([r[1] for r in records])
        verts = None
        if records[0][2] is not None:
            verts = np.stack([r[2] for r in records])
        if self._host_augment is not None:
            imgs, masks = self._host_augment(imgs, masks, rng)
            if self._regen:
                # MM-WHS parity: clouds regenerated from the warped masks
                # (data_generator_mmwhs.py:256-264)
                verts = np.stack([mask_to_point_cloud(m) for m in masks]).astype(np.float32)
        out = {"img": imgs, "mask": masks}
        if verts is not None:
            out["vert"] = verts
        return out


def shard_index_batch(idx, lo: int, hi: int, target: int):
    """Multi-host row sharding of one GLOBAL index batch.

    Wrap-pads the batch to the static ``target`` size (same semantics as
    ``parallel.pad_batch``: pad rows repeat real samples and carry mask 0),
    then keeps only rows ``lo:hi``, the slice one process holds under batch
    sharding. Every process runs the same sampler stream, so the
    concatenation of the per-process slices is EXACTLY the single-process
    global batch.

    Returns ``(local_indices, local_sample_mask)``.
    """
    idx = np.asarray(idx)
    n = len(idx)
    full = idx[np.arange(target) % n]
    mask = (np.arange(target) < n).astype(np.float32)
    return full[lo:hi], mask[lo:hi]


class PairedIterator:
    """One UDA epoch: zip of source and target streams (the reference's
    ``zip(trainA_iterator, trainB_iterator)``, which stops at the shorter;
    both samplers draw the same n_samples so lengths match).

    ``row_shard=(lo, hi, target)`` enables multi-host operation: the global
    index batches are wrap-padded to ``target`` and only rows ``lo:hi`` are
    decoded on this process (see :func:`shard_index_batch`).

    On the host augmentation route, as in the JAX package, every process
    seeds its numpy generator alike and draws only for the rows it decodes:
    N ranks' augmented batches are not the one-process run's (the device
    route draws for the global batch), and MM-WHS's min-max round trip
    spans the rank's rows only."""

    def __init__(
        self,
        src_sampler: RingSampler,
        tgt_sampler: RingSampler,
        src_assemble: BatchAssembler,
        tgt_assemble: BatchAssembler,
        seed: int = 0,
        row_shard=None,
    ):
        self._src_sampler = src_sampler
        self._tgt_sampler = tgt_sampler
        self._src = src_assemble
        self._tgt = tgt_assemble
        self._rng = np.random.default_rng(seed)
        self._row_shard = row_shard
        self.steps_per_epoch = min(src_sampler.steps_per_epoch, tgt_sampler.steps_per_epoch)

    def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
        for src_idx, tgt_idx in zip(self._src_sampler.epoch(), self._tgt_sampler.epoch()):
            if len(src_idx) != len(tgt_idx):  # truncated tail: drop, like zip of uneven tails
                break
            mask = None
            if self._row_shard is not None:
                lo, hi, target = self._row_shard
                src_idx, mask = shard_index_batch(src_idx, lo, hi, target)
                tgt_idx, _ = shard_index_batch(tgt_idx, lo, hi, target)
            a = self._src(src_idx, self._rng)
            b = self._tgt(tgt_idx, self._rng)
            batch = {"img_s": a["img"], "mask_s": a["mask"], "img_t": b["img"]}
            if mask is not None:
                batch["sample_mask"] = mask
            # the target mask never reaches the loss (unlabelled domain) but
            # rides along for device-side cloud regeneration after warping
            # (the reference's generators decode it for the same reason)
            if "mask" in b:
                batch["mask_t"] = b["mask"]
            if "vert" in a:
                batch["vert_s"] = a["vert"]
            if "vert" in b:
                batch["vert_t"] = b["vert"]
            yield batch


class BatchPadder:
    """Pads raw host batches to a static leading dim.

    Remembers the largest (rounded-up) batch size seen on its stream and
    pads every smaller batch up to it, so the ``ns % bs`` / ``len(val) % bs``
    tail batch (``src/data_generator_mscmrseg.py:281-291``) has the shape of
    the others: BatchNorm sees a full batch and cuDNN one shape. Pad semantics
    (wrap + mask): :func:`pointcloududa_torch.parallel.pad_batch`.
    """

    def __init__(self, multiple: int = 1):
        self._multiple = max(1, int(multiple))
        self._target = 0

    def __call__(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        n = next(iter(raw.values())).shape[0]
        self._target = max(self._target, -(-n // self._multiple) * self._multiple)
        return pad_batch(raw, self._multiple, self._target)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A copy of every array of a host batch on ``device``. Tensors that are
    already there pass through."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


class DevicePrefetcher:
    """Runs an iterator in a background thread, placing batches on the device
    ``depth`` batches ahead, while the consumer's thread enqueues the step.

    With a CUDA ``device`` the feeder thread works under
    ``torch.cuda.device(device)`` on a copy stream of its own, so a copy can
    run beside the step's kernels instead of queueing behind them on the
    consumer's stream. What that needs, and how it is met:

    * order: the feeder records an event after a batch's copies; the consumer
      makes its current stream wait for that event before it hands the batch
      on, so no kernel reads a tensor before its copy has landed;
    * lifetime: a tensor allocated on the copy stream belongs to that stream's
      pool, and the allocator could give its memory to the next copy while
      the consumer's kernels still read it; ``record_stream`` tells it that the
      consumer's stream uses the tensor too;
    * the staging buffer: the source arrays are pageable numpy memory, and a
      copy from pageable memory returns only once the CUDA runtime has taken the
      bytes into its own staging area, so the array may be dropped as soon as
      ``place`` returns. No pinned memory is allocated here, so none has to be
      released (a 16 x 256 x 256 x 3 float32 batch is 12.6 MB; over a
      training run pinned buffers per batch would only grow the host's locked
      memory for a copy that takes about a millisecond of a ~280 ms step).

    An exception in the feeder (a missing file, a failed copy) is re-raised
    in the consumer when it reaches that point of the stream.
    """

    _END = object()

    def __init__(self, place: Callable, depth: int = 2, device=None):
        self._place = place
        self._depth = depth
        self._device = torch.device(device) if device is not None else None
        self._wait = trace_annotation(QUEUE_WAIT)

    def __call__(self, it: Iterator) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err = []
        on_card = self._device is not None and self._device.type == "cuda"

        def feed():
            try:
                if not on_card:
                    for item in it:
                        q.put((self._place(item), None))
                    return
                with torch.cuda.device(self._device):
                    stream = torch.cuda.Stream(self._device)
                    for item in it:
                        with torch.cuda.stream(stream):
                            placed = self._place(item)
                            ready = torch.cuda.Event()
                            ready.record(stream)
                        q.put((placed, ready))
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                q.put(self._END)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        while True:
            with self._wait as wait:  # the consumer starved of batches; its calls count the batches handed out
                item = q.get()
                if item is self._END:
                    wait.discard()
                    if err:
                        raise err[0]
                    return
                placed, ready = item
                if ready is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(ready)
                    for v in placed.values() if isinstance(placed, dict) else ():
                        if isinstance(v, torch.Tensor) and v.is_cuda:
                            v.record_stream(current)
            yield placed
