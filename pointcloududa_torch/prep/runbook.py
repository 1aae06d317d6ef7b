"""Shared scaffolding for the turnkey reproduction runbooks
(``prep/reproduce.py`` MS-CMRSeg, ``prep/reproduce_mmwhs.py`` MM-WHS): the
port's copy of the repository's ``tools/runbook.py``."""

from __future__ import annotations

import os
import shlex


def find_best_checkpoint(workdir: str) -> str:
    """Newest ``best_*`` checkpoint in ``workdir`` (the trainer's ``.Scr``
    rename keeps one per appendix; mtime picks the latest run, where a
    lexicographic sort would compare score strings of differing width)."""
    cands = [f for f in os.listdir(workdir) if f.startswith("best_")]
    if not cands:
        raise SystemExit(f"no best_* checkpoint in {workdir}")
    return os.path.join(
        workdir, max(cands, key=lambda f: os.path.getmtime(os.path.join(workdir, f)))
    )


def parse_train_args(raw, default):
    """``--train-args`` arrives as ONE shell-quoted string (argparse cannot
    accept option-like tokens through nargs='*'); split it like a shell."""
    if raw is None:
        return list(default)
    return shlex.split(raw) if isinstance(raw, str) else list(raw)


def drive(stages, run_stage, workdir: str, stage_filter: str = "",
          print_only: bool = False):
    """Run the (name, module, argv) triples in order, honouring
    ``--stage``/``--print-only`` semantics shared by both runbooks."""
    for name, mod, argv in stages:
        if stage_filter and stage_filter not in name:
            continue
        print(f"== [{name}] python -m {mod} " + " ".join(argv), flush=True)
        if not print_only:
            run_stage(mod, argv, workdir)
