"""Unified entry point: ``python -m pointcloududa_torch <command> [args...]``
(counterpart of the JAX package's dispatcher, with the same four commands:
the two training runs and the two volume evaluations)."""

import sys

COMMANDS = {
    "train-mscmrseg": "pointcloududa_torch.cli.train_mscmrseg",
    "train-mmwhs": "pointcloududa_torch.cli.train_mmwhs",
    "evaluate-mscmrseg": "pointcloududa_torch.cli.evaluate_mscmrseg",
    "evaluate-mmwhs": "pointcloududa_torch.cli.evaluate_mmwhs",
}


def main():
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help") or sys.argv[1] not in COMMANDS:
        print("usage: python -m pointcloududa_torch <command> [args...]")
        print("commands:", ", ".join(COMMANDS))
        sys.exit(0 if len(sys.argv) >= 2 and sys.argv[1] in ("-h", "--help") else 2)
    import importlib

    mod = importlib.import_module(COMMANDS[sys.argv[1]])
    mod.main(sys.argv[2:])


if __name__ == "__main__":
    main()
