"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program. Top-level module names are
compared whole: ``pointcloududa_torch`` begins with the JAX package's name."""

import ast
import os
import subprocess
import sys

from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pointcloududa_tpu"}
HERE = os.path.join(ROOT, "perfbench")


def _modules():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_under_perfbench_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imported_tops(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: f for p, f in found.items() if f}
    assert len(found) > 20  # the walk saw the harness, readers, reference and tests


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for p in _modules():
        if p.startswith(ref + os.sep):
            tops = set(_imported_tops(p))
            assert "pointcloududa_torch" not in tops and not (tops & FORBIDDEN), p


def test_a_dry_import_of_the_harness_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.harness, perfbench.calibrate, perfbench.spec\n"
        "from perfbench import spec\n"
        "import pointcloududa_torch.train.loop, pointcloududa_torch.cli.common\n"
        "for m in spec.load_benchmark()['end_to_end'] + spec.load_benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))\n" % ROOT
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(out.stdout.split())
    assert "pointcloududa_torch" in tops and "perfbench" in tops
    assert not tops & FORBIDDEN
