"""MM-WHS CT volume evaluation CLI (reference ``src/evaluate_mmwhs.py``;
counterpart of the JAX package's ``cli/evaluate_mmwhs.py``, same flags).

Evaluates a generator checkpoint on the 4 CT test patients
[1003, 1008, 1014, 1019] with 2.5-D stacking + KLC. ``-weight_dir`` names a
checkpoint FILE: the trainer's (e.g.
``weights/best_unet_model_checkpoint_<apdx>.Scr<score>``), the reference's
callback layout (its released ``.pt`` files) or a bare ``state_dict``.
Architecture flags can be inferred from the checkpoint name (the reference
parses the filename, ``evaluate_mmwhs.py:231-253``). ``-dtype`` is the
forward's compute type (``float32`` by default, as in the JAX package's CLI).
What differs from the JAX package's CLI: ``-no_packed`` parses and changes
nothing (this package has no packed layout). The forward runs on the current
CUDA device.

Usage:
  python -m pointcloududa_torch evaluate-mmwhs -weight_dir <best .Scr file> \
      -data_dir ./input
"""

from __future__ import annotations

import argparse

from pointcloududa_torch import config as _config
from pointcloududa_torch.cli.common import restored_generator
from pointcloududa_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-weight_dir", type=str, required=True, help="checkpoint file")
    p.add_argument("-data_dir", type=str, default="./input")
    p.add_argument("-bs", type=int, default=8)
    p.add_argument("-d4", action="store_true")
    p.add_argument("-extpn", action="store_true")
    p.add_argument("-from_name", action="store_true")
    p.add_argument("-ifhd", type=int, default=1)
    p.add_argument("-ifasd", type=int, default=1)
    p.add_argument("-nf", type=int, default=32)
    p.add_argument("-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute type of the forward; a checkpoint trained in either type loads")
    p.add_argument(
        "-no_packed",
        help="accepted for the JAX package's command lines and changes nothing: "
        "this package has no packed layout",
        action="store_true",
    )
    p.add_argument("-save", help="append per-patient rows to a csv", action="store_true")
    p.add_argument("-model_name", type=str, default="")
    p.add_argument("-csv", type=str, default="evaluation_of_models_tf.csv")
    p.add_argument("-toplot", help="save input/pred/GT triptychs to this dir", type=str, default="")
    p.add_argument(
        "-pat_ids", nargs="+", type=int, default=[1003, 1008, 1014, 1019],
        help="CT test patient ids (the reference's fixed four, "
        "evaluate_mmwhs.py:60)",
    )
    return p


def main(argv=None, device=None):
    """Evaluate, and return the evaluator's metrics. ``device=None`` is the
    current CUDA device (raising without one); the CPU tests pass
    ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)

    from pointcloududa_torch.eval import volume

    name = args.weight_dir
    d4 = args.d4 or (args.from_name and "d4lr" in name)
    extpn = args.extpn or (args.from_name and "extpn" in name)
    if args.from_name:
        tags = [t for t in ("d1lr", "d2lr", "d4lr", "softmax", "etpls", "Tetpls") if t in name]
        print("model:", ".".join(tags) if tags else "(plain unet)")
    cfg = _config.mmwhs_default(filters=args.nf, d4=d4, extpn=extpn, compute_dtype=args.dtype, data_dir=args.data_dir)
    gen = restored_generator(cfg, args.weight_dir, device)
    print("model loaded from", args.weight_dir)
    return volume.evaluate_mmwhs(
        cfg,
        gen,
        data_dir=args.data_dir,
        bs=args.bs,
        ifhd=bool(args.ifhd),
        ifasd=bool(args.ifasd),
        pat_ids=tuple(args.pat_ids),
        per_patient_csv=args.csv if args.save else None,
        model_name=args.model_name,
        plot_dir=args.toplot or None,
        device=device,
    )


if __name__ == "__main__":
    main()
