"""Command-line entry points (``python -m pointcloududa_torch <command>``):
the two training CLIs and the two volume-evaluation CLIs."""
