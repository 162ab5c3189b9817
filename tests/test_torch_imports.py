"""Boundaries of the port: what it imports, where it runs.

``repro_torch`` and ``chip_smoke.py`` import neither JAX nor the JAX
package (importing ``repro.core`` switches JAX to x64 for the whole
process); entry points default to CUDA and raise when there is none,
with no CPU fallback; ``chip_smoke.py`` fails without a card or without
the package beside it, and prints no result.
"""
import ast
import importlib
import inspect
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_every_kernel_has_a_cuda_source():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert _build.BUILD_DIR == ROOT / "build" / "kernels"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card contract is moot")


def test_default_device_raises_without_cuda():
    _no_cuda()
    from repro_torch.core.engine import PackageQueryEngine
    from repro_torch.core.hierarchy import Hierarchy
    from repro_torch.core.lp_kernel import solve_lp_kernel
    from repro_torch.device import resolve_device
    table = {"a": np.arange(10.0), "b": np.ones(10)}
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        PackageQueryEngine(table, ["a", "b"])
    with pytest.raises(RuntimeError, match="cuda"):
        Hierarchy(table, ["a", "b"], d_f=2, alpha=2)
    with pytest.raises(RuntimeError, match="cuda"):
        solve_lp_kernel(np.ones(3), np.ones((1, 3)), np.array([1.0]),
                        np.array([2.0]), np.ones(3))
    eng = PackageQueryEngine(table, ["a", "b"], device="cpu")
    assert eng.device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


# helpers that take their caller's tensor device, never a user's choice
DEVICE_FROM_CALLER = {"repro_torch.models.layers.sinusoidal_positions"}


def _device_parameters():
    import repro_torch
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != mod.__name__:
                continue
            fns = [(name, obj)] if inspect.isfunction(obj) else [
                (f"{name}.{k}", v) for k, v in vars(obj).items()
                if inspect.isfunction(v)] if inspect.isclass(obj) else []
            for qual, fn in fns:
                p = inspect.signature(fn).parameters.get("device")
                if p is not None:
                    yield f"{mod.__name__}.{qual}", p.default


def test_every_device_parameter_defaults_to_cuda():
    """Every function or method of the port that takes ``device=`` with a
    default defaults to "cuda" (the heap build and the seed scan too)."""
    found = dict(_device_parameters())
    for must in ("repro_torch.core.dlv.dlv_heap",
                 "repro_torch.core.dlv.dlv_1d_seed",
                 "repro_torch.core.dlv.dlv",
                 "repro_torch.core.engine.PackageQueryEngine.__init__"):
        assert found.get(must) == "cuda", must
    wrong = {q: d for q, d in found.items()
             if d is not inspect.Parameter.empty and d != "cuda"
             and q not in DEVICE_FROM_CALLER}
    assert not wrong


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    _no_cuda()
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails (first on the missing card here, else on the package)."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
