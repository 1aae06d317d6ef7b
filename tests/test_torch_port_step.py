"""The port's train step against the JAX package's ``make_train_step``:
generator with point head (``d4aux``: the Chamfer loss without D4) + D1 + D2
over three steps, the padded-tail path, dropout, lr and config checks.

Both packages start from the same weights (the port's init, carried into
flax by the JAX package's own importer of reference checkpoints,
``pointcloududa_tpu/utils/torch_import.py``) and step on the same synthetic
batches. Continuous metrics must agree at the tolerance of
tests/test_step_parity_torch.py (rtol 2e-3, atol 2e-4: f32 sums in another
order in two frameworks, compounded over the optimiser steps). Threshold
metrics (the discriminators' accuracies, fractions of patch logits >= 0) may
differ by two flipped decisions: a logit within fp noise of 0 lands on
either side. D4 is held in tests/test_torch_port_step_d4.py,
which says why.

The MM-WHS branches of the step (softmax + cross-entropy on probabilities,
entropy maps normalised by log C, D1 on probabilities, ``etpls``) are held
over three steps, and the ``-sgd`` generator over two, where every generator
parameter is compared after the steps through the weight bridge, the unused
``encoder.conv1_1`` included: it has no gradient, and weight decay and
momentum must move it all the same.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.config import mmwhs_default, mscmrseg_default
from pointcloududa_tpu.data.synthetic import synthetic_batch
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.train import step as jstep
from pointcloududa_tpu.utils import torch_import
from pointcloududa_torch.models.unet import Dropout
from pointcloududa_torch.train.state import create_train_state, get_generator_lr, set_generator_lr
from pointcloududa_torch.train.step import make_train_step
from pointcloududa_torch.utils import weights

BS = 4
RTOL, ATOL = 2e-3, 2e-4
IMPLS = [dict(chamfer_impl="pallas", bn_stats_impl="pallas"), dict(chamfer_impl="jnp", bn_stats_impl="xla")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch while a module of port tests runs: the
    test workers share the CPU cores, and OpenMP threads that spin while they
    wait take those cores from the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    base = dict(d1=True, d2=True, filters=8, crop_size=96, fc_inch=1, bs=BS, num_devices=1)
    base.update(kw)
    return mscmrseg_default(**base)


def _mmwhs_cfg(**kw):
    base = dict(softmax=True, d2=True, filters=8, crop_size=96, fc_inch=1, bs=BS, num_devices=1,
                chamfer_impl="jnp", bn_stats_impl="xla")
    base.update(kw)
    return mmwhs_default(**base)


_IMPORTERS = (torch_import.generator_variables, torch_import.discriminator_variables,
              torch_import.discriminator_variables, torch_import.pointnetcls_variables)


def _jax_state(cfg, models, seed):
    """The JAX package's initial train state holding the weights of the
    port's ``models``. ``eval_shape`` traces the JAX init for the tree to
    fill (compiling it would cost tens of seconds on the CPU)."""
    key = jax.random.PRNGKey(seed)
    template = jax.eval_shape(lambda k: jstate.create_train_state(cfg, k), key)
    nets = []
    for module, net, tx, importer in zip(
        models, (template.gen, template.d1, template.d2, template.d4), jstate.build_optimizers(cfg), _IMPORTERS
    ):
        if module is None:
            nets.append(None)
            continue
        v = importer(module.state_dict(), {"params": net.params, "batch_stats": net.batch_stats})
        v = jax.tree_util.tree_map(jnp.array, v)  # copies: the port updates its tensors in place
        nets.append(jstate.NetState(params=v["params"], batch_stats=v.get("batch_stats", {}),
                                    opt_state=tx.init(v["params"])))
    return jstate.UDATrainState(*nets, step=jnp.zeros((), jnp.int32), rng=key)


def _steps(cfg, seed=0):
    """(JAX step, JAX state, port state, port step) from the same weights,
    the port's init from ``seed``; D4, where enabled, without dropout in
    both."""
    st = create_train_state(cfg, seed=seed, device="cpu")
    models = list(jstate.build_models(cfg))
    if cfg.d4:
        models[3] = models[3].clone(drop=0.0)
        st.models[3].dropout.p = 0.0
    jst = _jax_state(cfg, st.models, seed)
    jfn = jstep.make_train_step(cfg, tuple(models), jstate.build_optimizers(cfg))
    return jfn, jst, st, make_train_step(cfg, st.models, st.optimizers)


def _decisions(cfg, key):
    """Decisions behind a threshold metric: D1/D2 patch logits, D4 samples."""
    if key.startswith("dis4"):
        return BS
    side = cfg.crop_size
    for _ in range(5):  # k4 s2 pad2 convs: 96 -> 49 -> 25 -> 13 -> 7 -> 4
        side = side // 2 + 1
    return BS * side * side


def _compare(cfg, jm, tm, where, special=None):
    """``special``: tolerances of named metrics that replace the default."""
    assert set(tm) == set(jm)
    for key, want in jm.items():
        tol = dict(rtol=0.0, atol=2.0 / _decisions(cfg, key)) if key.startswith("dis") else dict(rtol=RTOL, atol=ATOL)
        tol = (special or {}).get(key, tol)
        np.testing.assert_allclose(float(tm[key]), float(want), **tol, err_msg=f"{where} metric {key}")


@pytest.fixture(scope="module")
def jax_three_steps():
    """The JAX step's metrics over three steps from the port's init, with its
    Pallas kernels in interpret mode: compiled and run once, and held against
    both of the port's routes."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = _cfg(d4aux=True, **IMPLS[0])
    with pltpu.force_tpu_interpret_mode():
        jfn, jst, _, _ = _steps(cfg)
        history = []
        for i in range(3):
            jst, jm = jfn(jst, synthetic_batch(cfg, BS, seed=i))
            history.append({k: float(v) for k, v in jm.items()})
    return history


@pytest.mark.parametrize("impls", IMPLS, ids=["kernels", "plain"])
def test_three_steps_match_jax(impls, jax_three_steps):
    """The port's kernel route (``*_impl="pallas"``: on the CPU the kernels'
    autograd wiring around their plain versions) and its plain route, each
    over three steps."""
    cfg = _cfg(d4aux=True, **impls)
    st = create_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, st.models, st.optimizers)
    for i, jm in enumerate(jax_three_steps):
        st, tm = step(st, synthetic_batch(cfg, BS, seed=i))
        _compare(cfg, jm, tm, f"step {i}")
    assert st.step == 3


def test_mmwhs_softmax_etpls_three_steps_match_jax():
    """MM-WHS: 5 classes, softmax with the double-softmax cross-entropy,
    normalised entropy maps, D1 on probabilities, D2, and the direct entropy
    term on the source (``etpls``).

    ``seg_dice`` is a threshold metric here: the Dice of the hard argmax over
    5 logits that the default N(0, 0.02) init leaves within fp noise of each
    other, so after an Adam step some pixels pick another class. The JAX step
    against itself on the same batches with the samples permuted moves it by
    1.6e-3 and 7.3e-4 at steps 1 and 2 (tests/diag_torch_port_step_noise.py;
    every other metric stays within a tenth of the tolerance there, as the
    port does), so it is held to 4e-3: ~120 of the 36,864 pixels (one pixel
    moves the mean of the four Dice terms by ~3.4e-5)."""
    cfg = _mmwhs_cfg(d1=True, etpls=True)
    jfn, jst, st, step = _steps(cfg)
    for i in range(3):
        batch = synthetic_batch(cfg, BS, seed=10 + i)
        jst, jm = jfn(jst, batch)
        st, tm = step(st, batch)
        _compare(cfg, jm, tm, f"step {i}", special={"seg_dice": dict(rtol=0.0, atol=4e-3)})
    assert "d1_loss" in tm and "d2_loss" in tm and "ver_s_loss" not in tm


def test_mmwhs_sgd_two_steps_match_jax_in_every_generator_parameter():
    """``-sgd``: SGD with momentum 0.95 and weight decay 5e-4 on the
    generator. After two steps every generator tensor agrees with JAX's:
    trained parameters to 5e-2 of the tensor's largest update plus two f32
    ulps of the parameter, running statistics rtol 1e-4 / atol 1e-5, and the
    dead ``encoder.conv1_1`` weights, which only decay, to two f32 ulps (their
    update has no gradient in it). Why 5e-2: two SGD steps at lr 1e-3 move a
    parameter by 1e-6..1e-5, a few hundred of its f32 ulps, and the gradients
    through the BatchNorms carry summation noise; the JAX step against itself
    with the samples permuted differs by up to 3.9e-2 of a tensor's largest
    update, the port from JAX by up to 1.1e-2
    (tests/diag_torch_port_step_noise.py). A wrong momentum, decay or
    learning rate moves an update by tens of percent."""
    cfg = _mmwhs_cfg(sgd=True)
    jfn, jst, st, step = _steps(cfg)
    gen = st.models[0]
    before = {k: v.detach().clone() for k, v in gen.state_dict().items()}
    for i in range(2):
        batch = synthetic_batch(cfg, BS, seed=20 + i)
        jst, jm = jfn(jst, batch)
        st, tm = step(st, batch)
        _compare(cfg, jm, tm, f"step {i}")
    want = weights.generator_state_dict(jax.device_get({"params": jst.gen.params, "batch_stats": jst.gen.batch_stats}))
    got = gen.state_dict()
    assert set(want) == set(got)
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        g, w, old = got[key].numpy(), w.numpy(), before[key].numpy()
        if "running" in key:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)
            continue
        share = 0.0 if "conv1_1" in key else 5e-2
        tol = share * np.abs(w - old).max() + 2 * np.spacing(np.abs(old))
        assert (np.abs(g - w) <= tol).all(), f"{key}: max |diff| {np.abs(g - w).max()} vs update {np.abs(w - old).max()}"
    for key in ("encoder.conv1_1.0.weight", "encoder.conv1_1.0.bias"):
        assert gen.get_parameter(key).grad is not None and not gen.get_parameter(key).grad.any()
        decayed = np.abs(got[key].numpy()) < np.abs(before[key].numpy())
        assert decayed[before[key].numpy() != 0].all(), f"{key} did not decay"


def test_sample_mask_step_matches_jax():
    """The padded-tail path: every reduction drops the masked entries and
    the Chamfer falls back to the plain masked loss."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = _cfg(d4aux=True, chamfer_impl="pallas", bn_stats_impl="xla")
    batch = synthetic_batch(cfg, BS, seed=5)
    batch["sample_mask"] = np.array([1, 1, 1, 0], np.float32)
    with pltpu.force_tpu_interpret_mode():
        jfn, jst, st, step = _steps(cfg)
        _, jm = jfn(jst, batch)
        _, tm = step(st, batch)
    _compare(cfg, jm, tm, "masked step")


@pytest.mark.parametrize("p", [0.3, 0.5])
def test_dropout_rate(p):
    """Keep rate 1 - p within 5 sigma over 200k draws, kept values scaled by
    1 / (1 - p), identity in eval mode."""
    n = 200_000
    drop = Dropout(p)
    x = torch.ones(n)
    y = drop(x, torch.Generator().manual_seed(3))
    kept = y != 0
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    torch.testing.assert_close(y[kept], torch.full((int(kept.sum()),), 1 / (1 - p)))
    drop.eval()
    assert torch.equal(drop(x), x)


def test_generator_lr_roundtrip():
    st = create_train_state(_cfg(), seed=0, device="cpu")
    assert get_generator_lr(st) == pytest.approx(1e-3)
    set_generator_lr(st, 2e-4)
    assert get_generator_lr(st) == pytest.approx(2e-4)


@pytest.mark.parametrize(
    "bad",
    [dict(packed_level0=True), dict(packed_compute=True, packed_level0=True), dict(compute_dtype="bfloat16"),
     dict(bn_stats_impl="pallas", num_devices=2), dict(torch_bn_stats=False)],
)
def test_rejected_configs(bad):
    with pytest.raises(ValueError):
        create_train_state(_cfg(**bad), device="cpu")
