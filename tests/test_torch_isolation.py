"""The PyTorch port stands alone: no module of ``tpu_task_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package.

The check reads the sources' syntax trees rather than ``sys.modules``: an
interpreter may import jax at start-up on its own, so what is loaded proves
nothing about what the port asks for. ``tpu_task_torch`` shares its
prefix with ``tpu_task``, so names are compared by their first dotted
component."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "tpu_task"}


def _sources():
    return sorted((ROOT / "tpu_task_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def imported_roots(source: str):
    """The first dotted component of every module an ``import`` or
    ``from ... import`` statement names (relative imports stay inside the
    package and are skipped)."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_scan_covers_the_package_and_chip_smoke():
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert "chip_smoke.py" in names
    assert "tpu_task_torch/ml/ops/paged_attention.py" in names
    assert "tpu_task_torch/ml/serving/engine.py" in names
    assert "tpu_task_torch/ml/ops/attention.py" in names
    assert "tpu_task_torch/ml/train.py" in names
    assert "tpu_task_torch/serve/kvfleet.py" in names
    assert "tpu_task_torch/storage/backends.py" in names
    for module in ("serve/replica.py", "obs/trace.py", "obs/metrics.py",
                   "obs/export.py", "ml/profiling.py", "ml/checkpoint.py",
                   "ml/data.py", "ml/models/mnist.py", "ml/tree.py",
                   "ml/__init__.py", "ml/serving/step_graph.py",
                   "ml/serving/lora.py", "ml/serving/offload.py",
                   "ml/parallel/__init__.py", "ml/parallel/mesh.py",
                   "ml/parallel/sharding.py", "ml/parallel/gang.py",
                   "ml/parallel/follower.py", "ml/parallel/collectives.py"):
        assert f"tpu_task_torch/{module}" in names
    assert all((ROOT / n).exists() for n in names)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = sorted(set(imported_roots(path.read_text())) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _rank_sources():
    """What the ranks of an SPMD trainer run besides the package: the
    trainer scripts chip_smoke writes out and runs, and the rank-side
    helpers of the sharded-training tests."""
    import chip_smoke

    return {"chip_smoke.TRAIN_MESH_SCRIPT": chip_smoke.TRAIN_MESH_SCRIPT,
            "chip_smoke.TRAINER_SCRIPT": chip_smoke.TRAINER_SCRIPT,
            **{f"tests/{name}": (ROOT / "tests" / name).read_text()
               for name in ("torch_spmd_util.py",
                            "torch_train_mesh_cases.py")}}


@pytest.mark.parametrize("name", sorted(_rank_sources()))
def test_rank_scripts_import_no_jax(name):
    source = _rank_sources()[name]
    roots = set(imported_roots(source))
    assert "tpu_task_torch" in roots or "torch_spmd_util" in roots \
        or "torch" in roots
    assert not roots & FORBIDDEN, f"{name} imports {roots & FORBIDDEN}"


@pytest.mark.parametrize("source,found", [
    ("import jax.numpy as jnp", {"jax"}),
    ("from tpu_task.ml import serving", {"tpu_task"}),
    ("import tpu_task", {"tpu_task"}),
    ("from tpu_task_torch.ml import random", set()),
    ("import jaxlib", {"jaxlib"}),
    ("importlib.import_module('jax')", {"jax"}),
    ("from . import cache", set()),
])
def test_scanner_tells_the_package_from_its_port(source, found):
    assert set(imported_roots(source)) & FORBIDDEN == found
