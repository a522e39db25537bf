"""The port against the PyTorch reference's goldens, and the port's
boundary.

tests/goldens/reference_{fg,em}.npz were produced from the reference's own
`Diffusion_model` (tools/make_reference_goldens.py). They hold reference
state_dicts, which load straight into snsde_torch's DiffusionField (the
same module and parameter names), so the port is held to the bar
tests/test_reference_parity.py holds the JAX package to: f/g over the full
7x20 grid to atol 2e-6 / rtol 1e-5, EM trajectories to 1e-4 and gradients
to 1e-4 relative.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import ast
import pathlib

import numpy as np
import pytest
import torch

import snsde_torch
from snsde_torch.fields import DiffusionField
from snsde_torch.harness.classification import HarnessConfig, run_sepsis
from snsde_torch.harness.forecasting import ForecastConfig, run_mujoco
from snsde_torch.harness.robustness import SweepConfig
from snsde_torch.harness.sweep_sharded import (run_robustness_sweep_sharded,
                                               train_ists_cells_sharded)
from snsde_torch.kernels.fused_em import fused_em_solve, supports_fused
from snsde_torch.ops import BrownianGrid, CubicPath, make_grid, sdeint

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"


class _ConstPath:
    """Control-path stub: evaluate(t) -> the fixed [B, C] values the
    goldens were computed with."""

    def __init__(self, Xt):
        self.Xt = torch.as_tensor(Xt)

    def evaluate(self, t):
        return self.Xt


def _params(z, prefix):
    return {k[len(prefix):]: torch.as_tensor(np.array(z[k]))
            for k in z.files if k.startswith(prefix)}


def field_from_reference(params, C, H, io, no):
    layers = 1 + len({k.split(".")[1] for k in params
                      if k.startswith("linears.")})
    field = DiffusionField(C, H, H, layers, input_option=io, noise_option=no)
    field.load_state_dict(params, strict=True)
    return field


@pytest.fixture(scope="module")
def fg():
    return np.load(GOLDENS / "reference_fg.npz")


@pytest.mark.parametrize("io", range(7))
def test_fg_goldens_full_grid(fg, io):
    C, H, _ = (int(v) for v in fg["meta"])
    y = torch.as_tensor(fg["y"])
    path = _ConstPath(fg["Xt"])
    for no in range(20):
        pre = f"cfg_{io}_{no:02d}/"
        field = field_from_reference(_params(fg, pre + "param/"), C, H, io,
                                     no).bind(path)
        with torch.no_grad():
            for ti, t in enumerate(fg["t_vals"]):
                tt = torch.tensor(float(t), dtype=torch.float32)
                np.testing.assert_allclose(
                    field.f(tt, y).numpy(), fg[f"{pre}f/{ti}"], atol=2e-6,
                    rtol=1e-5, err_msg=f"f io={io} no={no} t={t}")
                np.testing.assert_allclose(
                    field.g(tt, y).numpy(), fg[f"{pre}g/{ti}"], atol=2e-6,
                    rtol=1e-5, err_msg=f"g io={io} no={no} t={t}")


@pytest.fixture(scope="module")
def em():
    return np.load(GOLDENS / "reference_em.npz")


def _em_case(em, name):
    pre = f"em_{name}/"
    io, no = (int(v) for v in em[pre + "options"])
    params = _params(em, pre + "param/")
    C = params["initial_network.weight"].shape[1]
    H = params["linear_out.weight"].shape[0]
    field = field_from_reference(params, C, H, io, no)
    times = em["times"]
    path = CubicPath(torch.as_tensor(em["coeffs"]), times)
    return pre, field.bind(path), path, times


def _check_em(em, pre, field, ys):
    np.testing.assert_allclose(ys.detach().numpy(), em[pre + "ys"],
                               atol=1e-4, rtol=1e-4)
    loss = (ys ** 2).mean()
    np.testing.assert_allclose(loss.item(), float(em[pre + "loss"]),
                               rtol=1e-5)
    loss.backward()
    grads = dict(field.named_parameters())
    names = [k[len(pre + "grad/"):] for k in em.files
             if k.startswith(pre + "grad/")]
    assert names
    for g in names:
        ref = em[pre + "grad/" + g]
        ours = grads[g].grad.double().numpy()
        rel = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-8)
        assert rel < 1e-4, f"{pre}{g}: relative error {rel:.2e}"


@pytest.mark.parametrize("name",
                         ["lsde", "lnsde", "gsde", "naivesde", "neuralsde"])
def test_em_goldens_eager_solver(em, name):
    pre, field, path, times = _em_case(em, name)
    bm = BrownianGrid(np.asarray(em["grid"]), torch.as_tensor(em["dW"]))
    ys = sdeint(field.f, field.g, torch.as_tensor(em["y0"]), times, bm=bm)
    _check_em(em, pre, field, ys)


@pytest.mark.parametrize("name", ["lsde", "lnsde", "gsde"])
def test_em_goldens_fused_solve(em, name):
    """The fused solve (its plain versions on the CPU) on the goldens'
    subdivided grid holds the same bar as the eager solver."""
    pre, field, path, times = _em_case(em, name)
    assert supports_fused(field)
    dt = float(em["dt"])
    grid, _ = make_grid(times, dt)
    np.testing.assert_allclose(grid, em["grid"], atol=1e-9)
    ys = fused_em_solve(field, path, times, torch.as_tensor(em["y0"]),
                        dt=dt, dW_override=torch.as_tensor(em["dW"]))
    _check_em(em, pre, field, ys)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_snsde():
    files = sorted((REPO / "snsde_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "optax", "snsde"), (
                f"{f.relative_to(REPO)} imports {mod}")


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_sepsis(HarnessConfig(), n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_mujoco(ForecastConfig(method="srk"), n=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_robustness_sweep_sharded(SweepConfig(max_epochs=1), n=48)
    X = np.zeros((8, 4, 2), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_ists_cells_sharded("gru", X, np.zeros(8, np.int64), [(0.0, 0)])
    with pytest.raises(RuntimeError, match="CUDA"):
        snsde_torch.resolve_device()
    assert snsde_torch.resolve_device("cpu") == torch.device("cpu")


def test_numeric_regime_is_exact_fp32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
