"""The port's models under the weight bridge against the JAX package's:
generator, D1/D2 and D4, eval and train forwards, and the running statistics
after one train forward. Inputs and weights come from a numpy seed.

Sizes: ``crop_size=96, fc_inch=1`` (96/16 = 6, and the point head's k6
VALID conv leaves 1x1); ``filters=8`` for the forwards, the reference width
``filters=32`` for the parameter counts. Tolerances: outputs scaled by their
largest magnitude agree to 5e-5 (generator: some 30 f32 convolutions summed
in another order), 1e-5 (D1/D2) and 1e-4 (D4, whose BatchNorms over a batch
of clouds amplify rounding); running statistics rtol and atol 1e-5 (1e-4 for
D4, for the same reason).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloududa_tpu.models import PointNetCls as JaxPointNetCls
from pointcloududa_tpu.models import SegmentationPointModel as JaxGen
from pointcloududa_tpu.models import UncertaintyDiscriminator as JaxDisc
from pointcloududa_tpu.models import feature_transform_regularizer as jax_ftr
from pointcloududa_torch.models import PointNetCls, SegmentationPointModel, UncertaintyDiscriminator
from pointcloududa_torch.models import feature_transform_regularizer
from pointcloududa_torch.utils import weights
from test_torch_port_step import one_torch_thread  # noqa: F401


def _shapes(model, x, **kw):
    """The shapes of ``model``'s flax variables; ``eval_shape`` traces the
    init and compiles nothing (a compiled init costs seconds per model on
    the CPU)."""
    return jax.eval_shape(lambda k: model.init(k, x, **kw), jax.random.PRNGKey(0))


def _init(model, x, seed=0, **kw):
    """flax variables of ``model`` with seeded random values: kernels normal
    with std 1/sqrt(fan_in), biases and BatchNorm means normal with std 0.1,
    BatchNorm scales and variances uniform in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if len(shape) >= 2:
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        return (0.1 * rng.normal(size=shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, _shapes(model, x, **kw))


def _count(tree):
    return sum(int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(tree))


def _scaled_close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale, atol=tol)


def _single_sample_params(tree):
    """The flax tree of a batch-size-1 PointNetCls: each norm's
    ``BatchNorm_0/{scale, bias}`` moved up into the norm's own scope."""
    if not isinstance(tree, dict):
        return tree
    if "BatchNorm_0" in tree:
        return dict(tree["BatchNorm_0"])
    return {k: _single_sample_params(t) for k, t in tree.items()}


def _stats_close(module, mutated, convert, tol=1e-5):
    """Running statistics of ``module`` against JAX's mutated batch_stats."""
    sd = convert(mutated)
    for k, v in module.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(), rtol=tol, atol=tol, err_msg=k)


GEN_KW = [
    dict(pointnet=True, fc_inch=1),
    dict(pointnet=True, fc_inch=1, extpn=True, heinit=True),
    dict(pointnet=False, drop=True),
]


@pytest.mark.parametrize("kw", GEN_KW, ids=["point", "extpn-he", "drop"])
def test_generator_matches_jax(kw):
    x = np.random.default_rng(0).uniform(size=(2, 96, 96, 3)).astype(np.float32)
    jm = JaxGen(filters=8, **kw)
    v = _init(jm, jnp.zeros((2, 96, 96, 3)), train=False)
    tm = SegmentationPointModel(filters=8, **kw)
    assert sum(p.numel() for p in tm.parameters()) == _count(v["params"])
    tm.load_state_dict(weights.generator_state_dict(v, drop=kw.get("drop", False)), strict=True)
    convert = lambda s: weights.generator_state_dict({"params": v["params"], "batch_stats": s}, kw.get("drop", False))  # noqa: E731

    tm.eval()
    with torch.no_grad():
        logits, _, points = tm(torch.tensor(x))
    want_logits, _, want_points = jm.apply(v, x, train=False)
    _scaled_close(logits.numpy(), want_logits, 5e-5)
    if kw["pointnet"]:
        _scaled_close(points.numpy(), want_points, 5e-5)

    # train forward (dropout off in both, so their masks need not match)
    jm_nodrop, tm_nodrop = JaxGen(filters=8, **{**kw, "drop": False}), tm
    for m in tm_nodrop.modules():
        if m.__class__.__name__ == "Dropout":
            m.p = 0.0
    tm_nodrop.train()
    with torch.no_grad():
        logits, _, _ = tm_nodrop(torch.tensor(x))
    (want_logits, _, _), mut = jm_nodrop.apply(v, x, train=True, mutable=["batch_stats"])
    _scaled_close(logits.numpy(), want_logits, 5e-5)
    _stats_close(tm_nodrop, mut["batch_stats"], convert)


def test_generator_kernel_bn_matches_plain_bn():
    """bn_kernel (bn_stats_impl="pallas") is an execution choice: on the CPU
    both routes give the same logits, gradients and running statistics."""
    x = torch.tensor(np.random.default_rng(1).uniform(size=(2, 96, 96, 3)).astype(np.float32))
    a = SegmentationPointModel(filters=8, pointnet=True, fc_inch=1, generator=torch.Generator().manual_seed(0))
    b = SegmentationPointModel(filters=8, pointnet=True, fc_inch=1, bn_kernel=True)
    b.load_state_dict(a.state_dict())
    outs = []
    for m in (a, b):
        logits, _, pts = m(x)
        (logits.square().mean() + pts.mean()).backward()
        outs.append((logits.detach(), m.encoder.encoder1.get_submodule("0").weight.grad,
                     m.decoder.decoder2_1.get_submodule("5").running_var))
    for u, w in zip(*outs):
        torch.testing.assert_close(u, w, rtol=1e-5, atol=1e-6)


def test_reference_parameter_counts():
    """filters=32: the reference generator's 13,483,844 parameters
    (unet.py:166) without the point head, and the JAX counts with it."""
    assert sum(p.numel() for p in SegmentationPointModel().parameters()) == 13_483_844
    v = _shapes(JaxGen(pointnet=True, fc_inch=1), jnp.zeros((1, 96, 96, 3)), train=False)
    tm = SegmentationPointModel(pointnet=True, fc_inch=1)
    assert sum(p.numel() for p in tm.parameters()) == _count(v["params"])


@pytest.mark.parametrize("ext", [False, True])
def test_discriminator_matches_jax(ext):
    x = np.random.default_rng(2).normal(size=(2, 96, 96, 4)).astype(np.float32)
    jm = JaxDisc(in_channel=4, ext=ext)
    v = _init(jm, jnp.zeros((2, 96, 96, 4)))
    tm = UncertaintyDiscriminator(4, ext=ext)
    assert sum(p.numel() for p in tm.parameters()) == _count(v["params"])
    tm.load_state_dict(weights.discriminator_state_dict(v), strict=True)
    with torch.no_grad():
        got = tm(torch.tensor(x))
    _scaled_close(got.numpy(), jm.apply(v, x), 1e-5)


@pytest.mark.parametrize("ft,ext", [(False, False), (True, True)], ids=["plain", "ft-ext"])
def test_pointnet_matches_jax(ft, ext):
    rng = np.random.default_rng(3)
    # clouds of different sizes and places, so that the batch variance of
    # D4's pooled features does not cancel in the fast variance (see
    # tests/test_torch_port_step_d4.py)
    size = np.arange(1, 5, dtype=np.float32)[:, None, None]
    pts = (rng.uniform(size=(4, 300, 3)) * size + rng.normal(size=(4, 1, 3))).astype(np.float32)
    jm = JaxPointNetCls(feature_transform=ft, ext=ext, drop=0.0)
    v = _init(jm, jnp.zeros((2, 300, 3)), train=False)
    tm = PointNetCls(feature_transform=ft, ext=ext, drop=0.0)
    assert sum(p.numel() for p in tm.parameters()) == _count(v["params"])
    tm.load_state_dict(weights.pointnetcls_state_dict(v), strict=True)

    tm.eval()
    with torch.no_grad():
        logit, trans, trans_feat = tm(torch.tensor(pts))
        one, _, _ = tm(torch.tensor(pts[:1]))
    want_logit, want_trans, want_tf = jm.apply(v, pts, train=False)
    _scaled_close(logit.numpy(), want_logit, 1e-4)
    _scaled_close(trans.numpy(), want_trans, 1e-4)
    if ft:
        _scaled_close(trans_feat.numpy(), want_tf, 1e-4)
        np.testing.assert_allclose(float(feature_transform_regularizer(trans_feat)), float(jax_ftr(want_tf)), rtol=1e-4)
    # batch size 1: per-sample norms, whose flax parameters sit one scope up
    _scaled_close(one.numpy(), jm.apply({"params": _single_sample_params(v["params"])}, pts[:1], train=False)[0], 1e-4)

    tm.train()
    with torch.no_grad():
        logit, _, _ = tm(torch.tensor(pts))
    (want_logit, _, _), mut = jm.apply(v, pts, train=True, mutable=["batch_stats"])
    _scaled_close(logit.numpy(), want_logit, 1e-4)
    _stats_close(tm, mut["batch_stats"], lambda s: weights.pointnetcls_state_dict({"params": v["params"], "batch_stats": s}),
                 tol=1e-4)
