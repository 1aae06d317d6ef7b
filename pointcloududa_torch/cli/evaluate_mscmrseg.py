"""MS-CMRSeg volume evaluation CLI (reference ``src/evaluate_mscmrseg.py``;
counterpart of the JAX package's ``cli/evaluate_mscmrseg.py``, same flags).

Evaluates a trained generator checkpoint on the 40 LGE test patients
(Dice/HD/ASD per structure). ``-model_dir`` names a checkpoint FILE: the
trainer's (e.g. ``weights/best_unet_model_checkpoint_<apdx>.Scr<score>``),
the reference's callback layout (its released ``.pt`` files) or a bare
``state_dict``. Model hyper-parameters come from flags (the reference infers
them by grepping the checkpoint FILENAME, ``evaluate_mscmrseg.py:249-259`` —
supported here via ``-from_name``). What differs from the JAX package's CLI:
``-dtype bfloat16`` is not ported (ROADMAP Queue 1 item 13) and is refused;
``-no_packed`` parses and changes nothing (this package has no packed
layout). The forward runs on the current CUDA device.

Usage:
  python -m pointcloududa_torch.cli.evaluate_mscmrseg -model_dir <file> \
      -data_dir ./input -klc
"""

from __future__ import annotations

import argparse

from pointcloududa_torch import config as _config
from pointcloududa_torch.cli.common import check_dtype, restored_generator
from pointcloududa_torch.utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-model_dir", type=str, required=True, help="checkpoint file")
    p.add_argument("-data_dir", type=str, default="./input")
    p.add_argument("-bs", type=int, default=8)
    p.add_argument("-klc", help="keep largest connected components", action="store_true")
    p.add_argument("-clahe", action="store_true")
    p.add_argument("-d4", help="checkpoint has the point head", action="store_true")
    p.add_argument("-from_name", help="infer flags from the checkpoint name", action="store_true")
    p.add_argument("-ifhd", type=int, default=1)
    p.add_argument("-ifasd", type=int, default=1)
    p.add_argument("-pat_lo", type=int, default=6)
    p.add_argument("-pat_hi", type=int, default=46)
    p.add_argument("-csv", type=str, default="")
    p.add_argument("-toplot", help="save input/pred/GT triptychs to this dir", type=str, default="")
    p.add_argument("-nf", type=int, default=32)
    p.add_argument("-dtype", choices=["float32", "bfloat16"], default="float32",
                   help="compute type; this package computes in float32 only and refuses bfloat16")
    p.add_argument(
        "-no_packed",
        help="accepted for the JAX package's command lines and changes nothing: "
        "this package has no packed layout",
        action="store_true",
    )
    return p


def main(argv=None, device=None):
    """Evaluate, and return the evaluator's metrics. ``device=None`` is the
    current CUDA device (raising without one); the CPU tests pass
    ``device="cpu"``."""
    args = build_parser().parse_args(argv)
    check_dtype(args)
    device = resolve_device(device)

    from pointcloududa_torch.eval import volume

    d4 = args.d4 or (args.from_name and ("d4lr" in args.model_dir or "d4aux" in args.model_dir))
    cfg = _config.mscmrseg_default(filters=args.nf, d4=d4, data_dir=args.data_dir)
    gen = restored_generator(cfg, args.model_dir, device)
    print("model loaded from", args.model_dir)
    return volume.evaluate_mscmrseg(
        cfg,
        gen,
        data_dir=args.data_dir,
        bs=args.bs,
        clahe=args.clahe,
        ifhd=bool(args.ifhd),
        ifasd=bool(args.ifasd),
        pat_id_range=(args.pat_lo, args.pat_hi),
        crop_size=cfg.crop_size,
        klc=args.klc,
        per_patient_csv=args.csv or None,
        plot_dir=args.toplot or None,
        device=device,
    )


if __name__ == "__main__":
    main()
