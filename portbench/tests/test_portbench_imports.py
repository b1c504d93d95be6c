"""Nothing the benchmark runs imports the JAX stack or the JAX package,
and the plain reference imports nothing of the port either. Module names
are compared by their top-level name (before the first dot) whole:
``scd_resnet_tpu_torch`` is the port, not the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(harness.HERE)
JAX_STACK = {"jax", "jaxlib", "flax", "optax", "scd_resnet_tpu"}
PORT = "scd_resnet_tpu_torch"


def imported_tops(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(folder: Path):
    return sorted(p for p in folder.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", sources(HERE), ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_source_imports_the_jax_stack(path):
    assert not imported_tops(path) & JAX_STACK


@pytest.mark.parametrize("path", sources(HERE / "reference"),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert PORT not in tops and not tops & JAX_STACK
    assert tops <= {"__future__", "contextlib", "importlib", "math", "types",
                    "typing", "numpy", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith(
                "portbench"):
            assert node.module.startswith("portbench.reference")


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "scd_resnet_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "scd_resnet_tpu.fake", sys)
    assert harness.forbidden_modules() == ["scd_resnet_tpu"]


def test_loaded_modules_after_a_run_and_of_the_reference():
    """In a fresh process: the reference loads nothing of the port; a
    whole serving run (window, reference, comparison) at a test's size
    leaves no module of the JAX stack loaded."""
    code = """
import sys
sys.path.insert(0, {root!r})
import portbench.reference.model, portbench.reference.serve
import portbench.reference.train, portbench.reference.precision
import portbench.reference.centerOffset, portbench.reference.cornerCPool
port = "scd_resnet_tpu_torch"
assert not [m for m in sys.modules if m.split(".")[0] == port]
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.run import run_cell
import scd_resnet_tpu_torch.infer.analyse as analyse
analyse.BATCH_SIZE = 4
bench = harness.benchmark()
entry = harness.cell(bench, "centerOffsetRes10.serve_slide")
files = harness.cell_files(bench, entry)
files["config"].update(arch="centerOffsetRes10q",
                       dims=[16, 16, 32, 64, 128, 64, 64, 64],
                       terminal_hidden=64)
files["traffic"].update(width=700, height=600, slides=1,
                        calibration_clips=2, device_batch=4,
                        reference_block=4)
result = run_cell(bench, entry, 7, 0.5, False, torch.device("cpu"),
                  files=files)[0]
assert result["correct"]
print("FOUND", harness.forbidden_modules())
""".format(root=str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(harness.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
