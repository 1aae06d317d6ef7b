"""Start the ranks of a data mesh on one host: one process a device.

``spawn(fn, devices, args)`` starts ``len(devices)`` processes with
``torch.multiprocessing``; rank r sets the launcher's environment
(``MASTER_ADDR=localhost``, a free ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), joins the process group on ``devices[r]``
(``mesh.init_distributed``), calls ``fn(mesh, *args)`` and leaves the group.
The parent returns each rank's result, in rank order. A rank that raises
stops the others (``torch.multiprocessing.spawn`` terminates them) and the
parent re-raises.

``fn`` and its arguments must pickle: ``fn`` is a function at a module's top
level. Results travel through files in a temporary directory (a pipe would
block a rank that returns a large result while the parent waits for it to
exit).
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
from typing import Callable, Optional, Sequence


def free_port() -> int:
    """A TCP port on localhost that no process listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, args: tuple, devices: list, port: int, backend: Optional[str], out: str) -> None:
    import torch.distributed as dist

    from pointcloududa_torch.parallel.mesh import create_mesh, init_distributed

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(len(devices)),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    device = init_distributed(backend, devices[rank])
    try:
        result = fn(create_mesh(len(devices), device), *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, devices: Sequence, args: tuple = (), backend: Optional[str] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``len(devices)`` ranks, rank r on
    ``devices[r]`` (two ranks may share a card over ``backend="gloo"``; NCCL
    refuses that); returns the ranks' results."""
    import torch.multiprocessing as mp

    devices = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="pcuda_ranks_") as out:
        mp.spawn(_rank_main, args=(fn, tuple(args), devices, free_port(), backend, out), nprocs=len(devices), join=True)
        results = []
        for rank in range(len(devices)):
            with open(os.path.join(out, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
