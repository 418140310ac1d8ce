"""Package rules of the PyTorch port: it never imports JAX, Flax or the JAX
package, and its entry points run on the GPU unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import mppi_generic_tpu_torch
from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics

PKG = pathlib.Path(mppi_generic_tpu_torch.__file__).parent
REPO = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mppi_generic_tpu")


def _modules():
    return sorted(PKG.rglob("*.py"))


def _forbidden(name):
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(PKG)))
def test_module_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name} imports {bad}"


def test_importing_every_module_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _modules()]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(sorted(bad))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _parts():
    return (DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
            GaussianDistribution.create(std_dev=[1.0, 1.0]))


def test_controller_defaults_to_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VanillaMPPI(*_parts(), num_timesteps=8, num_rollouts=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VanillaMPPI(*_parts(), num_timesteps=8, num_rollouts=16, device="cuda")


def test_controller_on_cpu_when_asked():
    ctrl = VanillaMPPI(*_parts(), num_timesteps=8, num_rollouts=16, device="cpu")
    assert ctrl.device == torch.device("cpu")
    state = ctrl.init_state(seed=1)
    assert state.control_mean.device == torch.device("cpu")
    res, _ = ctrl.solve(torch.tensor([2.0, 0.0, 0.0, 1.0]), state)
    assert res.control_mean.shape == (8, 2) and res.costs.shape == (16,)
    with pytest.raises(ValueError, match="kernel"):
        VanillaMPPI(*_parts(), kernel="pallas", device="cpu")
