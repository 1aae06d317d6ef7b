"""Data parallelism in the port (``pointcloududa_torch/parallel``) on the CPU:
two gloo ranks against one process on the global batch, and against the
JAX package's step on a 2-device mesh.

The ranks run ``tests/torch_port_ranks.py`` (filters 4, ``n_block`` 2, crop
32, a global batch of 4: two rows a rank), once for every case, in one spawn;
the test's own process runs the same functions without a mesh. What is held,
and how tightly:

- the train step, both routes (kernels: on CPU tensors the kernels' autograd
  wiring around their plain versions; plain): D1 + D2 over three steps,
  D1 + D2 + D4 over one, and D1 + D2 + D4 with dropout in the generator and
  in D4 over two. Against one process: metrics rtol 1e-4 (the largest gap
  seen is 3e-5, the dropout case's second step), the accuracies within two
  flipped decisions; parameter updates (new - initial) within 1e-4 of each
  tensor's largest update (D1 + D2; 4e-6 seen) or 1e-2 of it plus 1e-6 of
  the network's largest update (with D4, whose fast-variance norms amplify
  f32 sums in another order; 1.6e-3 seen; the biases a BatchNorm cancels
  have a true gradient of 0 and receive noise, hence the floor), plus two
  f32 ulps of the parameter; running statistics rtol 1e-4, atol 1e-5. Both
  ranks end with the same state, metrics and all-reduce count a step;
- the same steps against JAX's ``make_train_step`` on ``create_mesh(2)``
  from the same weights (compiled once a case): metrics at the tolerance of
  tests/test_torch_port_step.py (rtol 2e-3, atol 2e-4, two flipped
  decisions); after D1 + D2's three steps (SGD on the generator) every
  generator parameter at that file's SGD rule (5e-2 of the tensor's largest
  update plus two ulps) and the running statistics rtol 1e-4, atol 1e-5;
- the MM-WHS device preprocess (light augmentation, clouds by FPS), called
  twice: each rank's rows bit-equal to the one process's;
- the host augmentation route (heavy, the source clouds rebuilt on the
  host): each rank's raw batches equal the JAX package's ``PairedIterator``
  under the same ``row_shard`` (images as tests/test_torch_port_host_augment.py
  holds them);
- ``UDATrainer`` over 2 epochs with a truncated tail batch and validation
  sets that do not divide the batch: the same best epoch and checkpoint
  name, logged records rtol 1e-4 (accuracies two decisions), the final
  generator's parameters atol 1e-6 (Adam: 3e-7 seen) and running
  statistics rtol 1e-4, atol 1e-5; rank 1 writes under ``.rank1``;
- a global batch of 2 over 2 ranks through ``Norm1d``: the batch branch;
  the kernel-route BatchNorm's statistics and dx over two ranks: rtol 1e-5,
  atol 1e-6;
- the mesh helpers give the JAX package's row ranges and padding exactly;
  ``replicate`` refuses ranks whose states differ; ``average_grads`` leaves
  a ``None`` gradient ``None``.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from pointcloududa_tpu.config import mscmrseg_default as jax_mscmrseg_default
from pointcloududa_tpu.data.synthetic import synthetic_batch
from pointcloududa_tpu.parallel import batch_sharding
from pointcloududa_tpu.parallel import create_mesh as jax_create_mesh
from pointcloududa_tpu.parallel import replicate as jax_replicate
from pointcloududa_tpu.parallel import shard_batch as jax_shard_batch
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.train import step as jstep
from pointcloududa_torch.config import mscmrseg_default
from pointcloududa_torch.parallel import Mesh, init_distributed, launch, process_row_slice, shard_batch, trainer_row_shard
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.utils import weights

import torch_port_ranks as ranks
from test_torch_port_step import _jax_state, one_torch_thread  # noqa: F401

WORLD = 2
METRIC_RTOL = 1e-4
JAX_RTOL, JAX_ATOL = 2e-3, 2e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process, [rank 0, rank 1]) of ``ranks.run_all``, and the root of
    their files. Without TensorBoard in both (see ``run_all``)."""
    root = str(tmp_path_factory.mktemp("parallel"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(__import__("sys").modules, "torch.utils.tensorboard", None)
        one = ranks.run_all(None, root)
    two = launch.spawn(ranks.run_all, ["cpu"] * WORLD, (root,))
    return one, two, root


def _decisions(key: str, cfg) -> int:
    """The decisions behind an accuracy: D4's one a sample, D1's and D2's
    one a patch logit (k4 s2 pad2 convolutions, five of them)."""
    if key.startswith("dis4"):
        return cfg.bs
    side = cfg.crop_size
    for _ in range(5):
        side = side // 2 + 1
    return cfg.bs * side * side


def _metrics_close(got: dict, want: dict, cfg, rtol: float, atol: float, where: str) -> None:
    assert set(got) == set(want), where
    for key, w in want.items():
        tol = dict(rtol=0.0, atol=2.0 / _decisions(key, cfg)) if key.startswith("dis") else dict(rtol=rtol, atol=atol)
        np.testing.assert_allclose(got[key], w, **tol, err_msg=f"{where}: {key}")


def _updates_close(init: dict, got: dict, want: dict, share: float, floor: float, where: str) -> None:
    """Every trained tensor's update within ``share`` of its largest update,
    plus ``floor`` of its network's largest update, plus two ulps; running
    statistics rtol 1e-4, atol 1e-5."""
    largest = {}
    for k, old in init.items():
        net = k.split(".")[0]
        largest[net] = max(largest.get(net, 0.0), float(np.abs(want[k].astype(np.float64) - old).max()))
    for k, old in init.items():
        if k.endswith("num_batches_tracked"):
            assert got[k] == want[k], f"{where}: {k}"
        elif "running" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=f"{where}: {k}")
        else:
            u_got, u_want = got[k].astype(np.float64) - old, want[k].astype(np.float64) - old
            tol = share * np.abs(u_want).max() + floor * largest[k.split(".")[0]] + 2 * np.spacing(np.abs(old))
            bad = np.abs(u_got - u_want) > tol
            assert not bad.any(), f"{where}: update of {k} differs at {bad.sum()} of {bad.size}"


def _port_cfg(case: str, impls: str = "kernels"):
    return mscmrseg_default(**ranks.TINY, **ranks.CASES[case]["cfg"], **ranks.IMPLS[impls])


@pytest.mark.parametrize("impls", list(ranks.IMPLS))
@pytest.mark.parametrize("case", list(ranks.CASES))
def test_two_ranks_take_the_one_process_step(runs, case, impls):
    one, two, _ = runs
    key = f"step/{case}/{impls}"
    want = one[key]
    cfg = _port_cfg(case, impls)
    share, floor = (1e-4, 0.0) if case == "d1d2" else (1e-2, 1e-6)
    for rank, got in enumerate(r[key] for r in two):
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            _metrics_close(g, w, cfg, METRIC_RTOL, 0.0, f"rank {rank} step {i}")
        # the dropout case is held after its first step: its second compounds D4's noise
        last = 0 if case == "dropout" else -1
        _updates_close(want["init"], got["states"][last], want["states"][last], share, floor, f"rank {rank}")
    ends = [got[key]["states"][-1] for got in two]
    assert ends[0].keys() == ends[1].keys()
    for k, v in ends[0].items():
        assert np.array_equal(v, ends[1][k]), f"the ranks hold different {k}"
    assert two[0][key]["metrics"] == two[1][key]["metrics"]
    assert two[0][key]["all_reduces"] == two[1][key]["all_reduces"] and min(two[0][key]["all_reduces"]) > 0


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's step on a 2-device mesh from the port's seed-0 weights, each
    case compiled once: per case its metrics by step and its generator's
    state after the last step."""
    out = {}
    for case in ("d1d2", "d4"):
        spec = ranks.CASES[case]
        jcfg = jax_mscmrseg_default(**ranks.TINY, **spec["cfg"], num_devices=WORLD)
        st = create_train_state(_port_cfg(case, "plain"), seed=0, device="cpu")
        models = list(jstate.build_models(jcfg))
        if spec["d4_drop"] is not None:
            models[3] = models[3].clone(drop=spec["d4_drop"])
        mesh = jax_create_mesh(WORLD)
        jst = jax_replicate(_jax_state(jcfg, st.models, 0), mesh)
        jfn = jstep.make_train_step(jcfg, tuple(models), jstate.build_optimizers(jcfg))
        history = []
        for i in range(spec["steps"]):
            jst, jm = jfn(jst, jax_shard_batch(dict(synthetic_batch(jcfg, jcfg.bs, seed=i)), mesh))
            history.append({k: float(v) for k, v in jm.items()})
        gen = weights.generator_state_dict(jax.device_get({"params": jst.gen.params, "batch_stats": jst.gen.batch_stats}))
        out[case] = history, {f"gen.{k}": v.numpy() for k, v in gen.items()}
    return out


@pytest.mark.parametrize("case", ["d1d2", "d4"])
def test_two_ranks_take_jaxs_step_on_a_two_device_mesh(runs, jax_runs, case):
    _, two, _ = runs
    history, gen = jax_runs[case]
    cfg = _port_cfg(case)
    for impls in ranks.IMPLS:
        for rank, got in enumerate(two):
            run = got[f"step/{case}/{impls}"]
            for i, (g, w) in enumerate(zip(run["metrics"], history)):
                _metrics_close(g, w, cfg, JAX_RTOL, JAX_ATOL, f"{impls} rank {rank} step {i}")
            if case == "d1d2":
                # (the weight bridge carries no num_batches_tracked)
                init = {k: v for k, v in run["init"].items() if k.startswith("gen.") and "num_batches" not in k}
                _updates_close(init, run["states"][-1], gen, 5e-2, 0.0, f"{impls} rank {rank} against JAX")


def test_preprocess_rows_equal_the_one_process_rows(runs):
    one, two, _ = runs
    for rank, got in enumerate(two):
        lo, hi = process_row_slice(Mesh(WORLD, rank, torch.device("cpu")), ranks.PRE_CFG["bs"])
        for call, (g, w) in enumerate(zip(got["preprocess"], one["preprocess"])):
            assert set(g) == set(w) == {"img_s", "mask_s", "img_t", "vert_s", "vert_t"}
            for k in w:
                assert np.array_equal(g[k], w[k][lo:hi]), f"rank {rank} call {call}: {k}"


def test_host_augmented_rows_equal_jaxs_under_the_same_row_shard(runs):
    """The host augmentation route under two ranks, as in the JAX package:
    every process seeds its ``PairedIterator`` alike and draws only for the
    rows it decodes, so a rank's batch is JAX's ``PairedIterator``'s under
    the same ``row_shard`` (not the one-process run's rows). Masks, clouds
    and sample masks equal; images as the twins' are held."""
    from pointcloududa_tpu.data import loader as ref_loader
    from pointcloududa_tpu.ops.host_augment import make_host_augment as ref_make_host_augment
    from test_torch_port_host_augment import _images_close

    _, two, _ = runs
    bs = ranks.trainer_cfg().bs
    for rank, got in enumerate(r["host_augment"] for r in two):
        row_shard = trainer_row_shard(Mesh(WORLD, rank, torch.device("cpu")), bs)
        np.random.seed(ranks.HOST_GLOBAL_SEED)
        want = list(ranks.host_iterator(ref_loader, ref_make_host_augment, row_shard).epoch())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert list(g) == list(w) and "vert_s" in w and "sample_mask" in w
            for key in w:
                assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape, key
                if key.startswith("img"):
                    _images_close(g[key], w[key], 1.0, [True] * len(w[key]), f"rank {rank} {key}")
                else:
                    np.testing.assert_array_equal(g[key], w[key], err_msg=f"rank {rank} {key}")


def _records(path: str) -> list:
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]


def test_trainer_two_ranks_log_and_keep_what_one_process_does(runs):
    one, two, root = runs
    cfg = ranks.trainer_cfg()
    want = one["trainer"]
    for rank, got in enumerate(r["trainer"] for r in two):
        assert got["best_epoch"] == want["best_epoch"]
        assert os.path.basename(got["ckpt"]) == os.path.basename(want["ckpt"])
        where = os.path.join(root, "ranks", "w") if rank == 0 else os.path.join(root, "ranks", "w", ".rank1")
        assert os.path.dirname(got["ckpt"]) == where and os.path.isfile(got["ckpt"])
        for part in ("train", "valid"):
            _metrics_close(got[part], want[part], cfg, METRIC_RTOL, 1e-6, f"rank {rank} {part}")
        for k, v in got["gen"].items():
            if "running" in k:
                np.testing.assert_allclose(v, want["gen"][k], rtol=1e-4, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_allclose(v, want["gen"][k], rtol=0, atol=1e-6, err_msg=k)
    # the logs: rank 0 in the real directory, rank 1 under .rank1, each the one process's records
    (log_one,) = glob.glob(os.path.join(root, "r", "*", "metrics.jsonl"))
    (log0,) = glob.glob(os.path.join(root, "ranks", "r", "*", "metrics.jsonl"))
    (log1,) = glob.glob(os.path.join(root, "ranks", "r", ".rank1", "*", "metrics.jsonl"))
    want_records = _records(log_one)
    for log in (log0, log1):
        got_records = _records(log)
        assert len(got_records) == len(want_records) == 3 * cfg.epochs
        for g, w in zip(got_records, want_records):
            _metrics_close({k.split("/")[-1]: v for k, v in g.items()}, {k.split("/")[-1]: v for k, v in w.items()},
                           cfg, METRIC_RTOL, 1e-6, log)


def test_norm1d_takes_the_batch_branch_on_a_global_batch_of_two(runs):
    one, two, _ = runs
    want = one["norm1d"]
    assert want["tracked"] == 1  # the batch branch updates the running statistics; the per-sample one does not
    for rank, got in enumerate(r["norm1d"] for r in two):
        assert got["tracked"] == 1
        np.testing.assert_allclose(got["y"][0], want["y"][rank], rtol=1e-5, atol=1e-6)
        for k in ("running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_kernel_route_batchnorm_statistics_and_dx_over_two_ranks(runs):
    one, two, _ = runs
    want = one["bn"]
    for rank, got in enumerate(r["bn"] for r in two):
        lo, hi = process_row_slice(Mesh(WORLD, rank, torch.device("cpu")), 4)
        for k in ("mean", "var", "running_var"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6, err_msg=k)
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], want[k][lo:hi], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world,rows", [(2, 4), (2, 16), (4, 16), (8, 8), (4, 5)])
def test_mesh_helpers_give_jaxs_row_ranges(world, rows):
    """``process_row_slice`` is the span of JAX's batch
    sharding for each device; ``trainer_row_shard`` the span of the batch
    rounded up to the mesh; ``shard_batch`` pads an indivisible dict batch
    as JAX's does (wrap-around rows, a ``sample_mask``) and gives each rank
    the rows JAX's device holds."""
    jmesh = jax_create_mesh(world)
    target = -(-rows // world) * world
    spans = batch_sharding(jmesh).devices_indices_map((target,))
    batch = {"x": np.arange(rows, dtype=np.float32) * 3.0, "y": np.arange(2 * rows).reshape(rows, 2)}
    sharded = jax_shard_batch(dict(batch), jmesh)
    for rank, device in enumerate(jmesh.devices.flat):
        mesh = Mesh(world, rank, torch.device("cpu"))
        (span,) = spans[device]
        assert process_row_slice(mesh, target) == (span.start, span.stop)
        assert trainer_row_shard(mesh, rows) == (span.start, span.stop, target)
        mine = shard_batch(batch, mesh)
        assert set(mine) == set(sharded)
        for k, arr in sharded.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == device]
            assert np.array_equal(mine[k].numpy(), np.asarray(shard.data)), k
    assert trainer_row_shard(Mesh(1, 0, torch.device("cpu")), rows) is None  # one process decodes whole batches
    if rows % world:
        with pytest.raises(ValueError, match="must divide"):
            process_row_slice(Mesh(world, 0, torch.device("cpu")), rows)


def test_nccl_on_a_cpu_device_raises():
    """NCCL carries CUDA tensors only: asked for a CPU rank, ``init_distributed``
    refuses before it joins anything (nothing falls back to gloo)."""
    with pytest.raises(ValueError, match="nccl"):
        init_distributed(backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()


def test_the_bn_kernel_serves_several_devices():
    """``bn_stats_impl="pallas"`` with ``num_devices > 1`` builds: the kernel's
    statistics are all-reduced over the global batch."""
    st = create_train_state(mscmrseg_default(**ranks.TINY, fc_inch=0, bn_stats_impl="pallas", num_devices=2), device="cpu")
    assert st.models[0] is not None


def test_replicate_refuses_ranks_that_differ_and_average_grads_keeps_none(runs):
    _, two, _ = runs
    for got in two:
        assert got["replicate"] == {"equal_seeds": "same", "different_seeds": "refused"}
        assert got["average_grads"] == {"averaged": 1.5, "none_stays_none": True}


def test_the_port_replaces_neither_batchnorm_nor_the_step_with_torchs_wrappers():
    """Data parallelism goes through the port's own collectives: no module of
    the port and not ``chip_smoke.py`` names ``SyncBatchNorm`` (it would
    replace ``TwinBatchNorm``'s numerics and bypass the BN kernel) or
    ``DistributedDataParallel`` (its reducer expects one backward and one
    step a module, not the step's five phases)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = glob.glob(os.path.join(root, "pointcloududa_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(root, "chip_smoke.py"))
    for path in files:
        with open(path) as f:
            text = f.read()
        for name in ("SyncBatchNorm", "DistributedDataParallel"):
            assert name not in text, f"{os.path.relpath(path, root)} names {name}"
