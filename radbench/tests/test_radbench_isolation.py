"""Nothing a run loads is JAX or the JAX package, and the reference takes
nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SCRIPT = """
import pkgutil, importlib, sys, time
import radbench, radbench.traffic
for m in pkgutil.walk_packages(radbench.__path__, "radbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from radbench import run
for name in ("l60_batch", "l60_rfmip_calls", "l60_stream_4card_c262k"):
    from radbench.tests.helpers import run_small
    r = run_small(name, seconds=0.1)
    assert r["correct"], r
bad = sorted({m.split(".")[0] for m in sys.modules} & set(run.FORBIDDEN))
print("FORBIDDEN", bad)
print("PORT", "ecckd_tpu_torch" in sys.modules)
"""


def test_no_jax_or_jax_package_after_set_up_and_runs():
    """Top-level names compared whole: ``ecckd_tpu_torch`` is not
    ``ecckd_tpu``."""
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout
    assert "PORT True" in proc.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from radbench import run
    monkeypatch.setitem(sys.modules, "ecckd_tpu_torch_fake", object())
    assert "ecckd_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ecckd_tpu.fake", object())
    assert "ecckd_tpu" in run.forbidden_modules()


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    banned = {"ecckd_tpu_torch", "ecckd_tpu", "tools", "bench_cuda",
              "chip_smoke", "jax", "jaxlib", "flax"}
    files = sorted((ROOT / "radbench" / "reference").glob("*.py"))
    assert len(files) >= 2
    for path in files:
        assert not _imports(path) & banned, path
        assert _imports(path) <= {"__future__", "dataclasses", "typing",
                                  "numpy", "scipy", "torch", "math",
                                  "radbench"}, path


def test_harness_imports_neither_jax_nor_the_jax_package():
    for path in (ROOT / "radbench").rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "ecckd_tpu",
                                     "tools", "bench_cuda"}, path
