"""What a run loads: no JAX and nothing of the JAX package (whole
top-level names: the port's name begins with the JAX package's), and a
reference that imports nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import core

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_names_are_whole_top_level_names():
    mods = ["tooncrafter_tpu_torch.models.unet", "jaxtyping", "flaxen",
            "tooncrafter_tpu", "jax.numpy", "flax", "jaxlib.xla"]
    assert core.forbidden_modules(mods) == ["flax", "jax.numpy",
                                            "jaxlib.xla", "tooncrafter_tpu"]
    assert core.forbidden_modules(["tooncrafter_tpu_torch"]) == []


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.run, benchmark.calibrate;"
            "from benchmark.harness import core;"
            "import benchmark.traffic.i2v, benchmark.traffic.train;"
            "import tooncrafter_tpu_torch.models.diffusion;"
            "import tooncrafter_tpu_torch.training.trainer;"
            "print(core.forbidden_modules())" % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_only_torch_numpy_and_itself():
    allowed = {"torch", "numpy", "math", "dataclasses", "typing",
               "__future__", "benchmark"}
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in allowed, (path.name, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), name


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.reference.model, benchmark.reference.diffusion,"
            " benchmark.reference.training;"
            "print(sorted(m for m in sys.modules"
            " if m.startswith('tooncrafter')"
            " or m.split('.')[0] in ('jax', 'flax')))" % str(core.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
