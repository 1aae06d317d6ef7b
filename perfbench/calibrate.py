"""The readings the limits of ``correct`` are set from, on the card, for one
cell over many seeds in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds <n> [<n> ...] [--out <file>]

For each seed it builds the program's trainer and runs its first three
steps as a benchmark run's set-up does (``harness.first_steps``), then the
plain reference from the same weights and batches, and prints one JSON line
with the numbers of ``correctness`` for:

* ``program``: the program against the reference (sound runs: the lower
  reading of each limit);
* ``control``: the reference with every convolution's and linear layer's
  operands rounded to the precision below the configuration's
  (``correctness.control_rounding``: TF32 under float32, float8 e4m3 under
  bfloat16), against the reference; its ``chamfer_gap`` and ``bn_gap`` put
  the plain kernels one precision lower (``correctness.kernel_gaps``) in
  place of the program's kernels, on the arguments the program's first
  step gave them;
* ``program_tf32`` (float32 configurations): the program's own path one
  precision lower, its first three steps with PyTorch's TF32 switched on
  for cuDNN's convolutions and for matmuls, against the reference (its
  kernels run in float32 either way, so its kernel numbers are the
  program's);
* ``half_batch``: the reference with half of each batch left out and the
  means taken over the rest, against the reference;
* ``rounding``: the look's witness, no control: the reference with its
  BatchNorm statistics summed in float64 (rounded once to float32) against
  the reference, which shows how far rounding alone moves each number.

A step that returns its state unchanged reads 1 on ``change_gap`` by
construction (every change is 0) and needs no run.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def d4_look(cfg, ref_cfg, weights: dict, ref_cloud, prog_cloud, device) -> dict:
    """D4's forward and backward (its logits and the gradient of their sum
    with respect to the cloud), from ``weights``: the program's module
    against the reference's on the reference's first-step cloud
    (``same_input``), and the reference's on the program's first-step cloud
    against its own (``program_cloud``: the cloud's gap beside what D4 makes
    of it)."""
    import torch

    from perfbench import correctness
    from perfbench.reference.state import build_models as reference_models
    from pointcloududa_torch.train.state import build_models as program_models

    port = program_models(cfg)[3].to(device)
    port.load_state_dict(weights["d4"])
    with torch.device("meta"):
        ref = reference_models(ref_cfg, None)[3]
    ref = ref.to_empty(device=device)
    ref.load_state_dict(weights["d4"])

    def run(module, cloud):
        x = cloud.detach().to(device).clone().requires_grad_(True)
        module.train()
        logit = module(x, torch.Generator(device=device).manual_seed(5))[0]
        logit.sum().backward()
        return logit.detach(), x.grad

    def gaps(a, b):
        return {"logit": correctness.rel_l2(a[0], b[0]), "cloud_grad": correctness.rel_l2(a[1], b[1])}

    want = run(ref, ref_cloud)
    return {"same_input": gaps(run(port, ref_cloud), want),
            "program_cloud": {"cloud": correctness.rel_l2(prog_cloud.to(device), ref_cloud),
                              **gaps(run(ref, prog_cloud), want)}}


def main(argv=None) -> int:
    import argparse
    import gc
    import json

    import torch

    from perfbench import correctness, harness, spec
    from perfbench.reference import numerics
    from perfbench.weights import make_weights

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.resolve(args.workload)
    device = torch.device("cuda")
    out = open(args.out, "a") if args.out else None

    def program(seed, tf32):
        built = harness.first_steps(cell, seed, device, tf32=tf32)
        got = {k: built[k] for k in ("prog", "stage", "cfg", "ref_cfg")}
        got["raws"] = built["pool"][:correctness.STEPS]
        built["trainer"].writer.close()
        built["tmp"].cleanup()
        del built
        gc.collect()
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        return got

    for seed in args.seeds:
        t = time.perf_counter()
        got = program(seed, False)
        prog, stage, cfg, ref_cfg, raws = (got[k] for k in ("prog", "stage", "cfg", "ref_cfg", "raws"))
        step_round, kernel_round = correctness.control_rounding(ref_cfg.compute_dtype)
        tf32_run = program(seed, True) if ref_cfg.compute_dtype == "float32" else None
        weights = make_weights(ref_cfg, seed, device)

        def run(**kw):
            return correctness.reference_readings(ref_cfg, weights, raws, device, **kw)

        ref, ref_stage = run()

        def numbers(readings, st, **kw):
            return correctness.check_numbers(readings, st, ref, ref_stage, device, **kw)

        line = {"workload": cell.name, "seed": seed}
        line["program"] = numbers(prog, stage, calls=stage["calls"])
        control, c_stage = run(operand_round=step_round)
        line["control"] = numbers(control, c_stage, calls=stage["calls"], lower=kernel_round)
        if tf32_run is not None:
            line["program_tf32"] = numbers(tf32_run["prog"], tf32_run["stage"], calls=tf32_run["stage"]["calls"])
        half, h_stage = run(batch_fn=correctness.half_batch)
        line["half_batch"] = numbers(half, h_stage)
        with numerics.float64_bn_statistics():
            witness, w_stage = run()
        line["rounding"] = numbers(witness, w_stage)
        if ref_cfg.d4:
            line["d4"] = d4_look(cfg, ref_cfg, weights, ref_stage["outputs"][1], stage["outputs"][1], device)
        line["look"] = {"program": correctness.describe(prog, ref), "control": correctness.describe(control, ref),
                        "rounding": correctness.describe(witness, ref)}
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if out is not None:
            out.write(text + "\n")
            out.flush()
        del weights, stage, ref_stage, c_stage, h_stage, w_stage, tf32_run
        gc.collect()
        torch.cuda.empty_cache()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
