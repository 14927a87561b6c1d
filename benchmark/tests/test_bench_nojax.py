"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "layout2img_tpu"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports (relative imports
    are the benchmark's own)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("benchmark" if node.level else node.module.split(".", 1)[0])
    return names


def _benchmark_imports(path: Path) -> set[str]:
    """The benchmark's own modules the file imports, by full name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("benchmark"):
            names.update(f"{node.module}.{a.name}" for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names if a.name.startswith("benchmark"))
    return names


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(BENCH)): sorted(_imports(p) & FORBIDDEN)
             for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_the_run_compares_top_level_names_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "layout2img_tpu_torch_probe", sys)
    assert "layout2img_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "layout2img_tpu.probe", sys)
    assert "layout2img_tpu" in run.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        names = _imports(p)
        assert "layout2img_tpu_torch" not in names, p
        assert names <= {"__future__", "contextlib", "dataclasses", "functools", "importlib",
                         "math", "numpy", "typing", "torch", "benchmark"}, (p, names)
        inside = _benchmark_imports(p)
        assert all(m.startswith("benchmark.reference") for m in inside), (p, inside)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, importlib, pathlib\n"
            "for p in sorted(pathlib.Path('benchmark').rglob('*.py')):\n"
            "    if 'tests' in p.parts or 'metrics' in p.parts: continue\n"
            "    importlib.import_module('.'.join(p.with_suffix('').parts).removesuffix('.__init__'))\n"
            "from benchmark import spec\n"
            "for p in pathlib.Path('benchmark/metrics').glob('*.py'): spec.reader(p.stem)\n"
            "print(sorted({n.split('.', 1)[0] for n in sys.modules} & %r))" % FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
