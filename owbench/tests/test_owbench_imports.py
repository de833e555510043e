"""What a run loads: nothing of JAX or the JAX package (`openwhisk_tpu`),
and a reference that loads nothing of the port. Module names are compared
by their whole top-level name, so `openwhisk_tpu_torch` is not
`openwhisk_tpu`."""
import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT
from owbench import run

JAX_SIDE = {"jax", "jaxlib", "flax", "openwhisk_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r})"
         f"\n{code}\nimport json; print(json.dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_top_level_imports(path)) & JAX_SIDE, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_top_level_imports(path))
        assert "openwhisk_tpu_torch" not in names and not names & JAX_SIDE
    loaded = _loaded_after("\n".join(
        f"import owbench.reference.{p.stem}"
        for p in sorted((BENCH / "reference").glob("*.py"))
        if p.stem != "__init__"))
    assert not loaded & (JAX_SIDE | {"openwhisk_tpu_torch", "torch"})


def test_a_run_loads_the_port_and_nothing_of_jax():
    loaded = _loaded_after(
        "import owbench.lib.cell, owbench.run\n"
        "import openwhisk_tpu_torch.controller.loadbalancer.tpu_balancer")
    assert "openwhisk_tpu_torch" in loaded
    assert not loaded & JAX_SIDE


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = run.forbidden_modules()
    for name in ("openwhisk_tpu_torch", "openwhisk_tpu_torch.ops",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "openwhisk_tpu.ops.placement", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"openwhisk_tpu", "jaxlib"} <= set(run.forbidden_modules())


def test_run_refuses_without_a_card():
    """On a machine without enough CUDA cards the run prints no result."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "ow10k-conc.fanout", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
