"""How far bfloat16 rounding alone moves the models, the train step and the
evaluation: the noise behind the tolerances of ``test_torch_port_bf16.py``.

Not a test (pytest does not collect it). Run from the repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/diag_torch_port_bf16_noise.py

Every JAX function is compiled without XLA's excess precision, as in the
tests (``strict_jit``). It prints:

0. what the excess precision does: D4's first norm in JAX (jitted at XLA's
   default, then strict) against the port's, fed JAX's own input, as the
   share of outputs that differ;
1. each generator stage alone (the second conv block of every encoder and
   decoder level, and the f32 classifier), fed JAX's input: the share of its
   outputs that differ from JAX's;
2. whole models (filters 8, 96^2, bs 4; D4 on 4 clouds of 300 points):
   the largest difference scaled by the largest magnitude, port against JAX
   and JAX against itself on an input nudged by 1 bf16 ulp in a share of its
   elements;
3. one train step of MS-CMRSeg D1+D2+D4 and of MM-WHS softmax D2+D4: every
   metric's difference as a multiple of the f32 step tolerance (rtol 2e-3,
   atol 2e-4), port against JAX and JAX against itself on the batch with
   its samples permuted;
4. the evaluate CLIs with ``-dtype bfloat16`` on the tiny generators and
   data of the tests: the share of label voxels the port's differ from the
   JAX CLI's in, per volume.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_port_bf16 as T  # noqa: E402
from test_torch_port_models import GEN_KW, _init  # noqa: E402
from test_torch_port_step import ATOL, BS, IMPLS, RTOL, _cfg, _mmwhs_cfg, _steps  # noqa: E402
from pointcloududa_tpu.data.synthetic import synthetic_batch  # noqa: E402
from pointcloududa_tpu.models import PointNetCls as JP  # noqa: E402
from pointcloududa_tpu.models import SegmentationPointModel as JG  # noqa: E402
from pointcloududa_tpu.models import UncertaintyDiscriminator as JD  # noqa: E402
from pointcloududa_torch.models import PointNetCls, SegmentationPointModel, UncertaintyDiscriminator  # noqa: E402
from pointcloududa_torch.utils import weights  # noqa: E402

BF16 = jnp.bfloat16
PERM = np.array([2, 0, 3, 1])


def nudge(x, share, seed=9):
    """``x`` rounded to bf16, with ``share`` of its elements one bf16 ulp up."""
    xb = T._f32(jnp.asarray(x).astype(BF16))
    sel = np.random.default_rng(seed).uniform(size=x.shape) < share
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(xb), 1e-30))) - 7)
    return np.where(sel, xb + ulp, xb).astype(np.float32)


def _clouds():
    rng = np.random.default_rng(3)
    size = np.arange(1, 5, dtype=np.float32)[:, None, None]
    return (rng.uniform(size=(4, 300, 3)) * size + rng.normal(size=(4, 1, 3))).astype(np.float32)


def excess_precision():
    print("0. D4's first norm fed JAX's input: share of outputs that differ from JAX's")
    pts = _clouds()
    v = _init(JP(drop=0.0), jnp.zeros((2, 300, 3)), train=False)
    jm = JP(drop=0.0, compute_dtype=BF16)
    tm = PointNetCls(drop=0.0, compute_dtype=torch.bfloat16)
    tm.load_state_dict(weights.pointnetcls_state_dict(v))
    tm.train()
    fn = lambda v, p: jm.apply(v, p, train=True, mutable=["batch_stats", "intermediates"], capture_intermediates=True)  # noqa: E731
    for name, run in (("XLA's default", jax.jit(fn)), ("strict", T.strict_jit(fn))):
        stn = run(v, pts)[1]["intermediates"]["feat"]["stn"]
        x = torch.tensor(T._f32(stn["conv1"]["__call__"][0])).to(torch.bfloat16).transpose(1, 2).contiguous()
        with torch.no_grad():
            got = tm.feat.stn.bn1(x).transpose(1, 2)
        print(f"  {name:14s} {(T._f32(got) != T._f32(stn['n_conv1']['__call__'][0])).mean():.3g}")


def stages():
    print("1. generator stages alone, fed JAX's input (eval): share of outputs that differ")
    x = np.random.default_rng(0).uniform(size=(4, 96, 96, 3)).astype(np.float32)
    kw = GEN_KW[0]
    v = _init(JG(filters=8, **kw), jnp.zeros((4, 96, 96, 3)), train=False)
    jm = JG(filters=8, compute_dtype=BF16, **kw)
    tm = SegmentationPointModel(filters=8, compute_dtype=torch.bfloat16, **kw)
    tm.load_state_dict(weights.generator_state_dict(v))
    tm.eval()
    it = T.strict_jit(lambda v, a: jm.apply(v, a, train=False, capture_intermediates=True, mutable=["intermediates"]))(v, x)[1]
    it = it["intermediates"]
    nchw = lambda a: torch.tensor(T._f32(a)).permute(0, 3, 1, 2).contiguous()  # noqa: E731
    for part, fmt in (("encoder", "encoder{}_conv"), ("decoder", "decoder2_{}_conv")):
        for i in range(1, 5):
            name = fmt.format(i)
            block = getattr(getattr(tm, part), name[:-5])
            y = nchw(it[part][name + "1"]["__call__"][0]).to(torch.bfloat16)
            with torch.no_grad():
                for j in (3, 4, 5):
                    y = block.get_submodule(str(j))(y)
            want = T._f32(it[part][name + "2"]["__call__"][0])
            print(f"  {name + '2':18s} {(T._f32(y.permute(0, 2, 3, 1)) != want).mean():.3g}")
    with torch.no_grad():
        y = tm.classifier(nchw(it["decoder"]["decoder2_1_conv2"]["__call__"][0]))
    print(f"  classifier (f32)   {T._scaled(y.permute(0, 2, 3, 1), it['classifier']['__call__'][0]):.3g} (scaled)")


def models():
    print("2. whole models: max |difference| / max |value|; port vs JAX, and JAX vs JAX on a nudged input")
    x = np.random.default_rng(0).uniform(size=(4, 96, 96, 3)).astype(np.float32)
    kw = GEN_KW[0]
    v = _init(JG(filters=8, **kw), jnp.zeros((4, 96, 96, 3)), train=False)
    jm = JG(filters=8, compute_dtype=BF16, **kw)
    tm = SegmentationPointModel(filters=8, compute_dtype=torch.bfloat16, **kw)
    tm.load_state_dict(weights.generator_state_dict(v))
    for train in (False, True):
        tm.train(train)
        run = T.strict_jit(lambda v, a: jm.apply(v, a, train=train, mutable=["batch_stats"])[0] if train
                           else jm.apply(v, a, train=False))
        with torch.no_grad():
            logits, _, points = tm(torch.tensor(x))
        want = run(v, x)
        nudged = [run(v, nudge(x, s)) for s in (1e-4, 1e-3)]
        for name, got, i in (("logits", logits, 0), ("points", points, 2)):
            print(f"  generator {'train' if train else 'eval '} {name}: port {T._scaled(got, want[i]):.3g}; nudged 1e-4 "
                  f"{T._scaled(nudged[0][i], want[i]):.3g}, 1e-3 {T._scaled(nudged[1][i], want[i]):.3g}")
    xd = np.random.default_rng(2).normal(size=(4, 96, 96, 4)).astype(np.float32)
    for ext in (False, True):
        v = _init(JD(in_channel=4, ext=ext), jnp.zeros((2, 96, 96, 4)))
        tm = UncertaintyDiscriminator(4, ext=ext, compute_dtype=torch.bfloat16)
        tm.load_state_dict(weights.discriminator_state_dict(v))
        run = T.strict_jit(JD(in_channel=4, ext=ext, compute_dtype=BF16).apply)
        with torch.no_grad():
            got = tm(torch.tensor(xd))
        want = run(v, xd)
        print(f"  D1/D2 ext={ext}: port {T._scaled(got, want):.3g}; nudged 1e-4 {T._scaled(run(v, nudge(xd, 1e-4)), want):.3g}, "
              f"1e-3 {T._scaled(run(v, nudge(xd, 1e-3)), want):.3g}")
    pts = _clouds()
    for ft, ext in ((False, False), (True, True)):
        v = _init(JP(feature_transform=ft, ext=ext, drop=0.0), jnp.zeros((2, 300, 3)), train=False)
        jm = JP(feature_transform=ft, ext=ext, drop=0.0, compute_dtype=BF16)
        tm = PointNetCls(feature_transform=ft, ext=ext, drop=0.0, compute_dtype=torch.bfloat16)
        tm.load_state_dict(weights.pointnetcls_state_dict(v))
        for train in (False, True):
            tm.train(train)
            run = T.strict_jit(lambda v, p: (jm.apply(v, p, train=True, mutable=["batch_stats"])[0] if train
                                             else jm.apply(v, p, train=False))[0])
            with torch.no_grad():
                got = tm(torch.tensor(pts))[0]
            want = run(v, pts)
            print(f"  D4 ft={ft} {'train' if train else 'eval '}: port {T._scaled(got, want):.3g}; nudged 1e-3 "
                  f"{T._scaled(run(v, nudge(pts, 1e-3)), want):.3g}, 1e-2 {T._scaled(run(v, nudge(pts, 1e-2)), want):.3g}")


def steps():
    from jax.experimental.pallas import tpu as pltpu

    print("3. one bf16 step: |difference| / (atol + rtol |jax|) at the f32 step tolerance")
    for name, cfg, seed in (("MS-CMRSeg D1+D2+D4 (kernel route)", _cfg(d4=True, compute_dtype="bfloat16", **IMPLS[0]), 0),
                            ("MM-WHS softmax D2+D4 (plain route)", _mmwhs_cfg(d4=True, compute_dtype="bfloat16"), 10)):
        print(f"  {name}")
        batch = synthetic_batch(cfg, BS, seed=seed)
        with pltpu.force_tpu_interpret_mode():
            jfn, jst, st, step = _steps(cfg)
            _, jst_p, _, _ = _steps(cfg)
            run = jfn.lower(jst, batch).compile(compiler_options=T.STRICT)
            _, jm = run(jst, batch)
            _, pm = run(jst_p, {k: v[PERM] for k, v in batch.items()})
            _, tm = step(st, batch)
        for key in sorted(jm):
            a, b, c = float(jm[key]), float(tm[key]), float(pm[key])
            tol = ATOL + RTOL * abs(a)
            print(f"    {key:16s} jax {a:.6f}  port {abs(a - b) / tol:7.2f}x  jax permuted {abs(a - c) / tol:7.2f}x")


def evaluation():
    import cv2

    from pointcloududa_torch.utils.nifti import save_nii

    print("4. evaluate CLIs, -dtype bfloat16: share of label voxels that differ from the JAX CLI's, per volume")
    root = tempfile.mkdtemp(prefix="bf16_noise_")
    try:
        rng = np.random.default_rng(0)  # tests/test_eval.py's fabricated patients
        os.makedirs(os.path.join(root, "ms/processed/trainB"))
        os.makedirs(os.path.join(root, "ms/raw_data/labels/lge_test_gt"))
        gt = np.zeros((40, 40, 3), np.int16)
        gt[10:20, 10:20], gt[20:28, 20:28] = 200, 500
        save_nii(os.path.join(root, "ms/raw_data/labels/lge_test_gt/patient6_LGE_manual.nii.gz"), gt)
        for i in range(3):
            cv2.imwrite(os.path.join(root, f"ms/processed/trainB/pat_6_lge_{i}.png"),
                        rng.integers(0, 255, size=(256, 256, 3)).astype(np.uint8))
        base = os.path.join(root, "mm/PnpAda_release_data/test_ct_image_n_labels")
        os.makedirs(base)
        rng = np.random.default_rng(0)
        img = rng.normal(size=(32, 32, 4)).astype(np.float32)
        gt = np.zeros((32, 32, 4), np.int16)
        gt[8:16, 8:16], gt[16:22, 16:22] = 1, 3
        save_nii(os.path.join(base, "image_ct_1003.nii.gz"), img)
        save_nii(os.path.join(base, "gth_ct_1003.nii.gz"), gt)
        for name, test, data in (("MS-CMRSeg", T.test_evaluate_mscmrseg_cli_bf16_labels_match_the_jax_cli, "ms"),
                                 ("MM-WHS", T.test_evaluate_mmwhs_cli_bf16_labels_match_the_jax_cli, "mm")):
            mp = _Patch()
            shares = []
            real = T._labels_agree
            T._labels_agree = lambda port, ref: shares.extend(float((a[1] != b[1]).mean()) for a, b in zip(port.seen, ref.seen))
            try:
                for preset in ("mscmrseg_default", "mmwhs_default"):
                    for mod in (T.port_config, T.ref_config):
                        real_preset = getattr(mod, preset)
                        mp.setattr(mod, preset, lambda _r=real_preset, **kw: _r(**{**kw, **T.TINY}))
                test(None, os.path.join(root, data), _Path(root), mp)
            finally:
                T._labels_agree = real
                mp.undo()
            print(f"  {name}: {', '.join(f'{s:.3%}' for s in shares)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


class _Path(str):
    def __truediv__(self, other):
        return _Path(os.path.join(self, other))


class _Patch:
    """The two methods of pytest's ``monkeypatch`` the evaluation tests use."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved = []


if __name__ == "__main__":
    torch.set_num_threads(2)
    excess_precision()
    stages()
    models()
    steps()
    evaluation()
