"""What decides ``correct``: the program's first three training steps,
taken in set-up through ``UDATrainer.train_epoch`` and the benchmark's feed,
against the plain reference (``perfbench/reference/``) from the same
weights, raw batches and seeds.

Nine numbers are compared, each against a limit of its own
(``perfbench/limits/<cell>.json``; PERF.md gives the readings each limit was
set from, and the look that chose them). Four hold the first step's stages,
which :class:`Recorder` keeps from the timed path, so that no later update
stands between a stage and its reading:

* ``batch_gap``: the largest absolute difference between the batch the
  program's step got (the device preprocess: crop, normalise, one-hot, the
  augmentation pipelines with their draws, FPS cloud regeneration) and the
  reference's preprocess of the same raw batch with the same generators
  (exact: the limit is 0);
* ``output_gap``: the generator's first output, the source logits and the
  regressed cloud, as the relative L2 gap (``|p - r| / |r|``) of the worse
  of the two (the convolutions, the BN-statistics kernel's forward, the
  point head);
* ``chamfer_gap``: the first call of the fused Chamfer forward and of its
  backward on the timed path, against the plain Chamfer recomputed from the
  same clouds (with the reference's own argmins): the worst relative L2 gap
  of the per-item parts and of the cloud's gradient;
* ``bn_gap``: the first call of the BN-statistics forward and backward
  kernels, against the plain statistics and their gradient from the same
  input: the worst relative L2 gap of mean, mean of squares and dx.

Five hold the step's result:

* ``loss_gap``: the worst relative gap over the first step's segmentation
  loss and the two image discriminators' losses;
* ``point_loss_gap``: the first step's point loss;
* ``gen_grad_gap`` and ``disc_grad_gap``: the first step's gradient as each
  optimiser got it, read from its state after the step (Adam:
  ``exp_avg / (1 - beta1)``; SGD: the momentum buffer, the gradient plus
  weight decay); per leaf the gap between the two norms over the
  reference's norm of that leaf or of the network's median leaf, whichever
  is larger; the network's median leaf (generator; the larger of D1's and
  D2's);
* ``change_gap``: each leaf's change after the three steps (parameters and
  the BatchNorm running statistics), measured the same way; the largest of
  the networks' median leaves. A parameter whose first gradient in the
  reference is under a thousandth of its network's median leaf moves under
  Adam by round-off alone and is left out.

A limit of ``null`` in a cell's file: the number is not compared there;
PERF.md names it with its readings and the look (``describe``;
``calibrate.py``'s ``rounding`` witness, the reference against itself with
its BN statistics summed in float64) that found why. Under the float32 the
configurations state, the program's stages and losses lie within a few
units of rounding of the reference, but the median leaf of a network's
first gradient swings with rounding alone at initialisation on a few seeds
(the witness reads as far as the program: D4 turns a rounding-level change
of its input into a far larger one in the gradients it passes back), so
where no control or fault reads well clear of that tail the number is left
out, and the steady numbers hold its stage.
"""

from __future__ import annotations

import math

import torch

NETS = ("gen", "d1", "d2", "d4")
STEPS = 3
LOSS_KEYS = ("seg_loss", "adv_loss", "gen_total_loss", "ver_s_loss", "d1_loss", "d2_loss", "d4_loss")
STEADY_LOSSES = ("seg_loss", "d1_loss", "d2_loss")  # step 1's losses that D4 does not drive
EXCLUDE_BELOW = 1e-3  # of the network's median first-gradient norm
STAGE_CHECKS = ("batch_gap", "output_gap", "chamfer_gap", "bn_gap")
CHECKS = STAGE_CHECKS + ("loss_gap", "point_loss_gap", "gen_grad_gap", "disc_grad_gap", "change_gap")
KERNELS = (("chamfer_kernel", "forward_fused"), ("chamfer_kernel", "side_grad"),
           ("bn_kernel", "stats_forward"), ("bn_kernel", "stats_backward"))
COUNTERS = ("launches", "bf16_launches")


def _host(tree):
    """A copy on the host of every tensor in a nested tuple/list/dict."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree


class Recorder:
    """Keeps, on the host, what the program's first step produces at each
    stage of its timed path: the batch ``pre_train`` hands the step, the
    generator's first output (source logits and cloud), and the first call
    of each kernel wrapper in ``KERNELS`` with its arguments and result.
    ``take`` puts the wrappers back (with the launches they counted) and
    returns ``{"batch", "outputs", "calls"}``."""

    def __init__(self, trainer):
        from pointcloududa_torch.ops import bn_kernel, chamfer_kernel

        mods = {"bn_kernel": bn_kernel, "chamfer_kernel": chamfer_kernel}
        self.batch, self.outputs, self.calls = None, None, {}
        self._trainer, self._pre = trainer, trainer.pre_train
        self._orig = [(mods[m], f, getattr(mods[m], f)) for m, f in KERNELS]
        for mod, name, fn in self._orig:
            setattr(mod, name, self._wrap(name, fn))
        trainer.pre_train = self._pre_train
        self._hook = trainer.state.models[0].register_forward_hook(self._generator_output)

    def _wrap(self, name, fn):
        def call(*args):
            out = fn(*args)
            if name not in self.calls:
                self.calls[name] = (_host(args), _host(out))
            return out

        for counter in COUNTERS:
            if hasattr(fn, counter):
                setattr(call, counter, getattr(fn, counter))
        return call

    def _pre_train(self, *args, **kwargs):
        batch = self._pre(*args, **kwargs)
        if self.batch is None:
            self.batch = _host(batch)
        return batch

    def _generator_output(self, module, args, out):
        if self.outputs is None:
            self.outputs = _host((out[0], out[2]))

    def take(self) -> dict:
        for mod, name, fn in self._orig:
            for counter in COUNTERS:
                if hasattr(fn, counter):
                    setattr(fn, counter, getattr(getattr(mod, name), counter))
            setattr(mod, name, fn)
        self._trainer.pre_train = self._pre
        self._hook.remove()
        return {"batch": self.batch, "outputs": self.outputs, "calls": self.calls}


def _nets(models):
    return [(n, m) for n, m in zip(NETS, models) if m is not None]


def grad_norms(models, optimizers) -> dict:
    """``{net: {leaf: 0-d tensor}}``: the norm of the gradient each optimiser
    took at its first step, from its state."""
    out = {}
    for (net, module), opt in zip(_nets(models), [o for o in optimizers if o is not None]):
        norms = {}
        for name, p in module.named_parameters():
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                norms[name] = torch.linalg.vector_norm(st["exp_avg"].float()) / (1.0 - opt.param_groups[0]["betas"][0])
            elif st.get("momentum_buffer") is not None:
                norms[name] = torch.linalg.vector_norm(st["momentum_buffer"].float())
        out[net] = norms
    return out


def change_norms(models, initial: dict) -> dict:
    """``{net: {leaf: 0-d tensor}}``: the norm of each floating leaf's change
    from ``initial`` (``{net: state_dict}``)."""
    out = {}
    for net, module in _nets(models):
        now = module.state_dict()
        out[net] = {k: torch.linalg.vector_norm((now[k].float() - v.float()))
                    for k, v in initial[net].items() if v.is_floating_point()}
    return out


def losses_of(metrics: list) -> list:
    return [{k: m[k] for k in LOSS_KEYS if k in m} for m in metrics]


def to_host(tree):
    """Every tensor of a nested dict/list as a Python float, in one copy."""
    flat = []

    def collect(t):
        if isinstance(t, dict):
            return {k: collect(v) for k, v in t.items()}
        if isinstance(t, list):
            return [collect(v) for v in t]
        flat.append(t.detach().float().reshape(()))
        return len(flat) - 1

    shape = collect(tree)
    values = torch.stack(flat).cpu().tolist() if flat else []

    def fill(s):
        if isinstance(s, dict):
            return {k: fill(v) for k, v in s.items()}
        if isinstance(s, list):
            return [fill(v) for v in s]
        return values[s]

    return fill(shape)


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else 0.0


def _rel(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(scale), 1e-30)


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Every gap ``compare`` takes its worst of: ``{"loss": {(step, key):
    gap}, "grad": {(net, leaf): gap}, "change": {(net, leaf): gap}}``."""
    out = {"loss": {}, "grad": {}, "change": {}}
    for i, (p, r) in enumerate(zip(prog["losses"], ref["losses"])):
        for k, rv in r.items():
            out["loss"][(i + 1, k)] = _rel(p.get(k, math.nan), rv, max(abs(rv), 1e-6))
    for net, rg in ref["grads"].items():
        pg = prog["grads"].get(net, {})
        med = _median(list(rg.values()))
        for leaf in set(rg) | set(pg):
            r = rg.get(leaf, 0.0)
            out["grad"][(net, leaf)] = _rel(pg.get(leaf, 0.0), r, max(r, med))
        rc, pc = ref["changes"][net], prog["changes"].get(net, {})
        kept = {k: v for k, v in rc.items() if k not in rg or rg[k] >= EXCLUDE_BELOW * med}
        cmed = _median(list(kept.values()))
        for leaf, r in kept.items():
            out["change"][(net, leaf)] = _rel(pc.get(leaf, math.nan), r, max(r, cmed))
    return out


def compare(prog: dict, ref: dict) -> dict:
    """The five numbers, from two readings (``{"losses", "grads",
    "changes"}`` on the host) of the program and the reference."""
    gaps = leaf_gaps(prog, ref)

    def median_of(kind, net):
        return _median([v for (n, _), v in gaps[kind].items() if n == net])

    out = {
        "loss_gap": max(gaps["loss"].get((1, k), 0.0) for k in STEADY_LOSSES),
        "point_loss_gap": gaps["loss"].get((1, "ver_s_loss"), 0.0),
        "gen_grad_gap": median_of("grad", "gen"),
        "disc_grad_gap": max(median_of("grad", n) for n in ("d1", "d2")),
        "change_gap": max(median_of("change", n) for n in ref["changes"]),
    }
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss_gap"] = math.inf
    return out


def describe(prog: dict, ref: dict, top: int = 6) -> dict:
    """The look behind ``compare``: each loss gap by step and key, and per
    network the median leaf gap and the ``top`` worst leaves."""
    gaps = leaf_gaps(prog, ref)
    out = {"loss": {f"{s}.{k}": v for (s, k), v in sorted(gaps["loss"].items())}}
    for kind in ("grad", "change"):
        per = {}
        for (net, leaf), v in gaps[kind].items():
            per.setdefault(net, []).append((v, leaf))
        out[kind] = {net: {"median": _median([v for v, _ in xs]),
                           "worst": [[leaf, v] for v, leaf in sorted(xs, reverse=True)[:top]]}
                     for net, xs in per.items()}
    return out


def reference_readings(cfg, weights: dict, raws: list, device, operand_round=None, batch_fn=None):
    """Run the reference three steps from ``weights`` on ``raws`` and take
    the same readings the program's set-up takes: (``{"losses", "grads",
    "changes"}`` on the host, ``{"batch", "outputs"}`` of its first step on
    ``device``)."""
    from perfbench.reference.iteration import ReferenceRun

    run = ReferenceRun(cfg, weights, device, operand_round=operand_round)
    stage = {}

    def keep_output(module, args, out):
        if "outputs" not in stage:
            stage["outputs"] = tuple(None if t is None else t.detach().clone() for t in (out[0], out[2]))

    hook = run.models[0].register_forward_hook(keep_output)
    batch = run.preprocess(raws[0])
    stage["batch"] = batch
    metrics = [run.step_on(batch if batch_fn is None else batch_fn(batch))]
    hook.remove()
    grads = grad_norms(run.models, run.optimizers)
    for raw in raws[1:STEPS]:
        metrics.append(run.iterate(raw, batch_fn))
    changes = change_norms(run.models, weights)
    out = to_host({"losses": losses_of(metrics), "grads": grads, "changes": changes})
    del run
    return out, stage


def rel_l2(p, r) -> float:
    """``|p - r| / |r|`` in float64; inf where the shapes differ or a value
    is not finite."""
    if p is None or r is None:
        return 0.0 if p is None and r is None else math.inf
    if tuple(p.shape) != tuple(r.shape):
        return math.inf
    r = r.to(torch.float64)
    p = p.to(device=r.device, dtype=torch.float64)
    gap = float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp_min(1e-300))
    return gap if math.isfinite(gap) else math.inf


def batch_gap(prog: dict, ref: dict) -> float:
    """The largest absolute difference over every tensor of two batches
    (inf where their keys or shapes differ)."""
    if prog is None or set(prog) != set(ref):
        return math.inf
    worst = 0.0
    for k, r in ref.items():
        if not isinstance(r, torch.Tensor):
            continue
        p = prog[k]
        if tuple(p.shape) != tuple(r.shape):
            return math.inf
        d = (p.to(device=r.device, dtype=torch.float64) - r.to(torch.float64)).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst if math.isfinite(worst) else math.inf


def _on(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_on(t, device) for t in tree)
    return tree


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def control_rounding(compute_dtype: str):
    """The control's precision, the nearest below the configuration's
    ``compute_dtype``: (the rounding of every product's operands in the
    reference's step, ``reference/numerics.py``'s layers, the rounding of the plain
    kernels' operands and results). float32 (TF32 off): TF32; bfloat16:
    float8 e4m3 in the step, bfloat16 in the kernels (their float32
    arguments)."""
    from perfbench.reference.numerics import fp8_e4m3, tf32

    return {"float32": (tf32, tf32), "bfloat16": (fp8_e4m3, _bf16)}[compute_dtype]


def kernel_gaps(calls: dict, device, lower=None) -> dict:
    """``chamfer_gap`` and ``bn_gap`` of recorded kernel calls: each result
    against the plain reference recomputed from the same arguments. With
    ``lower`` (the control's rounding, ``control_rounding``), the plain
    reference one precision lower (the clouds, the inputs and the results
    rounded) is judged in the kernels' place."""
    from perfbench.reference.bn import stats_backward_plain, stats_forward_plain
    from perfbench.reference.losses import chamfer_parts, chamfer_side_grad

    out = {"chamfer_gap": math.inf, "bn_gap": math.inf}
    if {"forward_fused", "side_grad"} <= set(calls):
        (x, y), (parts, _, _) = _on(calls["forward_fused"], device)
        (a, c, _, _, g), da = _on(calls["side_grad"], device)
        want = chamfer_parts(x, y)[0]
        _, i_ac, i_ca = chamfer_parts(a, c)
        want_da = chamfer_side_grad(a, c, i_ac, i_ca, g)
        if lower is not None:
            parts = lower(chamfer_parts(lower(x), lower(y))[0])
            _, j_ac, j_ca = chamfer_parts(lower(a), lower(c))
            da = lower(chamfer_side_grad(lower(a), lower(c), j_ac, j_ca, lower(g)))
        out["chamfer_gap"] = max(rel_l2(parts, want), rel_l2(da, want_da))
    if {"stats_forward", "stats_backward"} <= set(calls):
        (x,), (mean, meansq) = _on(calls["stats_forward"], device)
        (xb, g_mean, g_meansq), dx = _on(calls["stats_backward"], device)
        want_mean, want_meansq = stats_forward_plain(x)
        want_dx = stats_backward_plain(xb, g_mean, g_meansq)
        if lower is not None:
            mean, meansq = stats_forward_plain(lower(x))
            mean, meansq = lower(mean), lower(meansq)
            inv_n = 1.0 / (xb.numel() // xb.shape[1])
            shape = (1, -1) + (1,) * (xb.dim() - 2)
            gm, gq, xh = lower(g_mean.float()), lower(g_meansq.float()), lower(xb.float())
            dx = lower(gm.reshape(shape) * inv_n + xh * (2.0 * inv_n) * gq.reshape(shape))
        out["bn_gap"] = max(rel_l2(mean, want_mean), rel_l2(meansq, want_meansq), rel_l2(dx, want_dx))
    return out


def check_numbers(readings: dict, stage: dict, ref: dict, ref_stage: dict, device, calls: dict | None = None,
                  lower=None) -> dict:
    """Every number of ``CHECKS``, in that order, of one side against the
    reference: ``readings`` and ``stage`` as ``reference_readings`` returns
    them (the program's ``stage`` from ``Recorder.take``), and the recorded
    kernel ``calls`` whose results ``kernel_gaps`` judges (``None``: no
    kernel calls, the kernel numbers ``None``; ``lower``: the plain kernels
    one precision lower judged in their place)."""
    out = {"batch_gap": batch_gap(stage.get("batch"), ref_stage["batch"])}
    p_out, r_out = stage.get("outputs"), ref_stage["outputs"]
    out["output_gap"] = math.inf if p_out is None else max(rel_l2(p_out[0], r_out[0]), rel_l2(p_out[1], r_out[1]))
    out.update(kernel_gaps(calls, device, lower) if calls is not None else {"chamfer_gap": None, "bn_gap": None})
    out.update(compare(readings, ref))
    return {k: out[k] for k in CHECKS}


def half_batch(batch: dict) -> dict:
    """A planted fault: half of the batch left out, the means taken over the rest."""
    b = batch["img_s"].shape[0]
    return {k: v[: b // 2] for k, v in batch.items()}


def judge(numbers: dict, limits: dict) -> bool:
    """Every compared number finite and within its limit (``None``: not compared)."""
    return all(limits[k] is None or (numbers[k] is not None and math.isfinite(numbers[k]) and numbers[k] <= limits[k])
               for k in CHECKS)
