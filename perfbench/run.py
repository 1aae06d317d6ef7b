"""Run one cell of ``BENCHMARK.json`` once (from the root of a checkout):

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the run's result as one JSON object;
the numbers the check compared, each beside its limit, are the last lines
of standard error. Exits non-zero, printing no result, without enough CUDA
devices or for a name ``BENCHMARK.json`` lacks.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# caches the program or its libraries may write stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "perfbench", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "perfbench", "torch_extensions")
os.environ["USE_FLAX"] = "0"

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
