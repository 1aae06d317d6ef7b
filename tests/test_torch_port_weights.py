"""The weight bridge round trip: JAX variables -> the port's ``state_dict``
(``pointcloududa_torch.utils.weights``) -> the JAX package's own importer of
reference checkpoints (``pointcloududa_tpu/utils/torch_import.py``) -> the
same JAX variables, bit for bit (every step is a transpose or a rename)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict

from pointcloududa_tpu.config import mscmrseg_default
from pointcloududa_tpu.models import PointNetCls as JaxPointNetCls
from pointcloududa_tpu.models import SegmentationPointModel as JaxGen
from pointcloududa_tpu.models import UncertaintyDiscriminator as JaxDisc
from pointcloududa_tpu.train import state as jstate
from pointcloududa_tpu.utils import torch_import
from pointcloududa_torch.models import PointNetCls, SegmentationPointModel, UncertaintyDiscriminator
from pointcloududa_torch.train.state import create_train_state
from pointcloududa_torch.utils import weights
from test_torch_port_step import one_torch_thread  # noqa: F401


def _init(model, x, seed, **kw):
    """Seeded random flax variables of ``model`` (every leaf distinct, so the
    round trip cannot swap two); ``eval_shape`` traces the init for the
    shapes and compiles nothing."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: model.init(k, x, **kw), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32), shapes)


def _same(got, want):
    for col in ("params", "batch_stats"):
        g, w = flatten_dict(got.get(col, {})), flatten_dict(want.get(col, {}))
        assert set(g) == set(w), col
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=f"{col} {k}")


@pytest.mark.parametrize("kw", [dict(), dict(extpn=True, drop=True)], ids=["point", "extpn-drop"])
def test_generator_roundtrip(kw):
    jm = JaxGen(filters=8, pointnet=True, fc_inch=1, **kw)
    v = _init(jm, jnp.zeros((1, 96, 96, 3)), 0, train=False)
    sd = weights.generator_state_dict(v, drop=kw.get("drop", False))
    # the port's module takes it strictly, and the importer inverts it
    SegmentationPointModel(filters=8, pointnet=True, fc_inch=1, **kw).load_state_dict(sd, strict=True)
    _same(torch_import.generator_variables(sd, v), v)


@pytest.mark.parametrize("ext", [False, True])
def test_discriminator_roundtrip(ext):
    v = _init(JaxDisc(in_channel=4, ext=ext), jnp.zeros((1, 64, 64, 4)), 1)
    sd = weights.discriminator_state_dict(v)
    UncertaintyDiscriminator(4, ext=ext).load_state_dict(sd, strict=True)
    _same(torch_import.discriminator_variables(sd, v), v)


@pytest.mark.parametrize("ft,ext", [(False, False), (True, False), (True, True)])
def test_pointnetcls_roundtrip(ft, ext):
    v = _init(JaxPointNetCls(feature_transform=ft, ext=ext), jnp.zeros((2, 300, 3)), 2, train=False)
    sd = weights.pointnetcls_state_dict(v)
    PointNetCls(feature_transform=ft, ext=ext).load_state_dict(sd, strict=True)
    assert torch_import.detect_network_kind(sd) == "pointnet"
    _same(torch_import.pointnetcls_variables(sd, v), v)


def test_train_state_roundtrip():
    """All four networks of the triple-adversary config at once: the JAX
    train state's variables load strictly into the port's train state
    (``load_jax_variables``) and import back unchanged."""
    cfg = mscmrseg_default(d1=True, d2=True, d4=True, filters=8, crop_size=96, fc_inch=1)
    template = jax.eval_shape(lambda k: jstate.create_train_state(cfg, k), jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    nets = {}
    for key in ("gen", "d1", "d2", "d4"):
        net = getattr(template, key)
        nets[key] = jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                           {"params": net.params, "batch_stats": net.batch_stats})
    models = create_train_state(cfg, device="cpu").models
    weights.load_jax_variables(models, nets)
    importers = (torch_import.generator_variables, torch_import.discriminator_variables,
                 torch_import.discriminator_variables, torch_import.pointnetcls_variables)
    for key, module, importer in zip(("gen", "d1", "d2", "d4"), models, importers):
        _same(importer(module.state_dict(), nets[key]), nets[key])
