"""No module the benchmark loads has jax, jaxlib, flax or the JAX
package as its whole top-level name (the port's name begins with the
JAX package's, so names are compared whole), and the reference imports
nothing of the program."""

import ast
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = """
import sys, time
sys.path[:0] = [{root!r}, {bench!r}]
from conftest import run_small
res, _ = run_small("config4_orbit.eager", seconds=0.2)
from benchlib.harness import forbidden_modules
assert "software_renderer_tpu_torch" in sys.modules
print("FORBIDDEN", forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            bench=str(BENCH / "tests"))],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_forbidden_names_compare_whole():
    from benchlib import harness
    sys.modules.setdefault("software_renderer_tpu_torch_probe", sys)
    assert "software_renderer_tpu" not in harness.forbidden_modules() or \
        "software_renderer_tpu" in {m.split(".")[0] for m in sys.modules}


def test_reference_imports_nothing_of_the_program():
    """The yardstick (the reference, the comparison, the peaks, the
    inputs and the generators they are made by) imports nothing of the
    program."""
    files = [BENCH / "benchlib" / n for n in (
        "reference.py", "scene.py", "compare.py", "peaks.py", "inputs.py",
        "plugins.py")]
    for kind in ("scenes", "textures", "cameras"):
        files += sorted((BENCH / kind).glob("*.py"))
    for path in files:
        name = path.relative_to(BENCH)
        tree = ast.parse(path.read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module or "" for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
        names = {a.name for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) for a in n.names}
        assert not any(m.split(".")[0].startswith("software_renderer")
                       or m.split(".")[0] in ("jax", "jaxlib", "flax")
                       or m.endswith("program") for m in mods), (name, mods)
        assert "program" not in names and "drivers" not in names, name
