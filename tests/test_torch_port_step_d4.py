"""The port's triple-adversary train step (generator + D1 + D2 + D4, the
main path), D4's own updates, and the eval step against the JAX package's,
from the same weights.

The whole step with D4 is compared over one step. D4's BatchNorms use the
flax fast variance E[x^2] - E[x]^2 in f32, and the clouds the generator emits
are nearly identical across the batch, so the variance over the batch of
D4's pooled features cancels catastrophically. Its gradients then move with
the order of f32 sums: the JAX step alone, on the same batch in another
sample order (the same function), gives D4 losses and later generator
metrics that differ by several times the tolerance from step 1 on, as much
as the port does (PERF.md). The generator uses He init (``heinit``): at the
default N(0, 0.02) init its cloud collapses to one point (spread ~3e-7) and
D4 then normalises fp noise in both frameworks, even in the forward.

D4's backward and its SGD update (weight decay before momentum) are held over
three updates on clouds that differ across the batch, through the step's own
``discriminator_phase``, at the default init, on 16-point clouds (``_clouds``
says why). Tolerances as in
tests/test_torch_port_step.py unless stated.

The MM-WHS configuration with D4 (softmax, D2 + D4, 5 classes) is held the
same way over one step, and then as the whole slice: a raw MM-WHS batch
through each package's device preprocess (light augmentation and cloud
regeneration, the port replaying JAX's draws) and one train step.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pointcloududa_tpu.data.synthetic import synthetic_batch, synthetic_eval_batch
from pointcloududa_tpu.ops import losses as jlosses
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.train import step as jstep
from pointcloududa_tpu.utils import torch_import
from pointcloududa_torch.ops import losses
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.train.step import discriminator_phase, make_eval_step, make_train_step
from pointcloududa_torch.utils import weights
from pointcloududa_torch.config import mmwhs_default
from pointcloududa_torch.train.loop import make_device_preprocess
from test_torch_port_preprocess import mmwhs_light_case
from test_torch_port_step import BS, IMPLS, _cfg, _compare, _mmwhs_cfg, _steps, one_torch_thread  # noqa: F401

SEED = 3
# D4's parameter updates (new - old) agree to UPDATE_TOL of each tensor's
# largest update (f32 sums through 5 point convolutions, 3 dense layers and
# their BatchNorms in another order), plus FLOOR of D4's largest update (the
# biases a batch norm cancels have a true gradient of 0 and receive f32
# noise), plus two f32 ulps of the parameter (the update is rounded into it)
UPDATE_TOL, FLOOR = 1e-3, 1e-6


def _d4_state(d4):
    return {k: v.detach().clone() for k, v in d4.state_dict().items() if not k.endswith("num_batches_tracked")}


def _updates_close(before, port_after, jax_after, where):
    largest = max(float((jax_after[k] - old).abs().max()) for k, old in before.items() if "running" not in k)
    for k, old in before.items():
        if "running" in k:
            np.testing.assert_allclose(port_after[k].numpy(), jax_after[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{where}: {k}")
            continue
        got, want = (port_after[k] - old).numpy(), (jax_after[k] - old).numpy()
        tol = UPDATE_TOL * np.abs(want).max() + FLOOR * largest + 2 * np.spacing(np.abs(old.numpy()))
        bad = np.abs(got - want) > tol
        assert not bad.any(), f"{where}: update of {k} differs at {bad.sum()} of {bad.size}: {got[bad][:4]} vs {want[bad][:4]}"


@pytest.fixture(scope="module")
def jax_triple_step():
    """The metrics of one JAX step of the triple-adversary config from the
    port's init, with its Pallas kernels in interpret mode: run once."""
    from jax.experimental.pallas import tpu as pltpu

    cfg = _cfg(d4=True, heinit=True, **IMPLS[0])
    with pltpu.force_tpu_interpret_mode():
        jfn, jst, _, _ = _steps(cfg, SEED)
        _, jm = jfn(jst, synthetic_batch(cfg, BS, seed=4))
    return {k: float(v) for k, v in jm.items()}


def test_triple_adversary_step_matches_jax(jax_triple_step):
    jm = jax_triple_step
    cfg = _cfg(d4=True, heinit=True)
    st = create_train_state(cfg, seed=SEED, device="cpu")
    st.models[3].dropout.p = 0.0
    _, tm = make_train_step(cfg, st.models, st.optimizers)(st, synthetic_batch(cfg, BS, seed=4))
    _compare(cfg, jm, tm, "step 0")


MMWHS_D4 = dict(d4=True, heinit=True, aug="light")


@pytest.fixture(scope="module")
def jax_mmwhs_d4():
    """The JAX step of the MM-WHS D2 + D4 configuration (compiled once) from
    the port's init, plain implementations. The step donates its state, so
    each call steps a copy."""
    cfg = _mmwhs_cfg(**MMWHS_D4)
    jfn, jst, _, _ = _steps(cfg, SEED)
    return cfg, lambda batch: jfn(jax.tree_util.tree_map(jnp.copy, jst), batch)[1]


def _port_mmwhs_d4():
    cfg = mmwhs_default(**dataclasses.asdict(_mmwhs_cfg(**MMWHS_D4)))
    st = create_train_state(cfg, seed=SEED, device="cpu")
    st.models[3].dropout.p = 0.0
    return cfg, st, make_train_step(cfg, st.models, st.optimizers)


def test_mmwhs_d4_step_matches_jax(jax_mmwhs_d4):
    jcfg, jax_metrics = jax_mmwhs_d4
    batch = synthetic_batch(jcfg, BS, seed=6)
    jm = jax_metrics(batch)
    cfg, st, step = _port_mmwhs_d4()
    _, tm = step(st, batch)
    _compare(cfg, jm, tm, "step 0")
    assert {"d2_loss", "d4_loss", "ver_s_loss", "ver_t_loss"} <= set(tm) and "d1_loss" not in tm


def test_mmwhs_slice_raw_batch_to_step_matches_jax(jax_mmwhs_d4):
    """The slice as a whole: raw MM-WHS host batch -> device preprocess
    (augment both streams, regenerate both clouds, normalise, one-hot) ->
    one 5-phase step, in each package, the port replaying the draws of the
    JAX preprocess. Metrics at the step tolerance."""
    jcfg, jax_metrics = jax_mmwhs_d4
    raw, jbatch, draws = mmwhs_light_case(jcfg, jax.random.PRNGKey(9), jcfg.crop_size, seed=9)
    jm = jax_metrics(jbatch)
    cfg, st, step = _port_mmwhs_d4()
    batch = make_device_preprocess(cfg, train=True, device_augment=True, device="cpu")(None, raw, draws=draws)
    assert set(batch) == set(jbatch) == {"img_s", "mask_s", "img_t", "vert_s", "vert_t"}
    np.testing.assert_array_equal(np.rint(batch["vert_s"].numpy() * 255), np.rint(np.asarray(jbatch["vert_s"]) * 255))
    _, tm = step(st, batch)
    _compare(cfg, jm, tm, "slice")


def _clouds(seed, n=16):
    """Source and target batches of ``n``-point clouds that differ in size and
    place, so the batch variance of D4's pooled features does not cancel.

    16 points, not 300: the more points a max-pool takes, the likelier one of
    its argmaxes is a near-tie that f32 rounding decides, and the gradient
    then lands on another point. The JAX package alone, on the batch in
    another sample order, moves D4's gradients by up to 6% of their largest
    entry at 300 points; port against JAX, these clouds show such a flip by
    the third update at 32 points and none at 16, where the updates agree to
    ~1.3e-4."""
    rng = np.random.default_rng(seed)
    size = np.arange(1, BS + 1, dtype=np.float32)[:, None, None]
    return [(rng.uniform(size=(BS, n, 3)) * size + rng.normal(size=(BS, 1, 3))).astype(np.float32)
            for _ in range(2)]


def test_d4_updates_match_jax():
    """Three D4 updates at the main path's default init through the port
    step's ``discriminator_phase`` against a transcription of the JAX step's
    D4 phase (``pointcloududa_tpu/train/step.py:314-338``): BCE, running
    statistics (source, then target), parameters after SGD with momentum and
    weight decay. Then the gradient that D4's adversarial term sends into the
    generator's target cloud (phase 2)."""
    cfg = _cfg(d4=True)
    st = create_train_state(cfg, seed=SEED, device="cpu")
    d4, opt = st.models[3], st.optimizers[3]
    d4.dropout.p = 0.0
    init = _d4_state(d4)

    jd4 = jstate.build_models(cfg)[3].clone(drop=0.0)
    tx = jstate.build_optimizers(cfg)[3]
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(lambda k: jd4.init(k, jnp.zeros((BS, 16, 3)), train=False), key)
    v = jax.tree_util.tree_map(jnp.array, torch_import.pointnetcls_variables(d4.state_dict(), template))
    params, stats, opt_state = v["params"], v["batch_stats"], tx.init(v["params"])

    def forward(p, s, pts):
        (out, _, _), mut = jd4.apply({"params": p, "batch_stats": s}, pts, train=True, mutable=["batch_stats"],
                                     rngs={"dropout": key})
        return out, mut["batch_stats"]

    @jax.jit
    def jax_phase(p, s, o, src, tgt):
        def loss_fn(q):
            out_s, s1 = forward(q, s, src)
            out_t, s2 = forward(q, s1, tgt)
            return jlosses.bce_with_logits(out_s, 1.0) + jlosses.bce_with_logits(out_t, 0.0), s2

        (loss, s), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, o = tx.update(g, o, p)
        return optax.apply_updates(p, upd), s, o, loss

    port_logits = lambda pts: d4(pts)[0]  # noqa: E731
    for i in range(3):
        src, tgt = _clouds(i)
        params, stats, opt_state, want = jax_phase(params, stats, opt_state, src, tgt)
        got = discriminator_phase(port_logits, opt, torch.tensor(src), torch.tensor(tgt), None, 4)
        np.testing.assert_allclose(float(got["d4_loss"].detach()), float(want), rtol=1e-5, err_msg=f"update {i}")
        jax_d4 = weights.pointnetcls_state_dict(jax.device_get({"params": params, "batch_stats": stats}))
        _updates_close(init, _d4_state(d4), jax_d4, f"update {i}")

    # phase 2: d BCE(D4(cloud), source) / d cloud, D4 frozen, stats updated
    _, tgt = _clouds(3)
    want = jax.jit(jax.grad(lambda pts: jlosses.bce_with_logits(forward(params, stats, pts)[0], 1.0)))(tgt)
    pts = torch.tensor(tgt, requires_grad=True)
    losses.bce_with_logits(copy.deepcopy(d4)(pts)[0], 1.0).backward()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(pts.grad.numpy() / scale, np.asarray(want) / scale, atol=1e-4)


def test_eval_step_matches_jax():
    cfg = _cfg(d4=True, heinit=True, chamfer_impl="jnp", bn_stats_impl="xla")
    _, jst, st, _ = _steps(cfg, SEED)
    gen = st.models[0]
    batch = synthetic_eval_batch(cfg, BS)
    want = jstep.make_eval_step(cfg, jstate.build_models(cfg)[0])(jst.gen, batch)
    got = make_eval_step(cfg, gen)(batch)
    assert gen.training  # the eval step restores the mode it found
    for key in ("loss", "dice", "vert_loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=1e-4, atol=1e-4)
