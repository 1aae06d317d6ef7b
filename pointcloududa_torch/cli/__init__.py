"""Command-line entry points (``python -m pointcloududa_torch <command>``):
the two training CLIs. The evaluation CLIs are not ported yet."""
