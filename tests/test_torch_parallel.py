"""The process mesh and data-parallel training of the port
(snsde_torch/parallel/, fit_classifier(mesh=)) on the CPU.

Two ranks are spawned once for the whole file (tests/torch_dp_ranks.py:
gloo, a file:// store under tmp_path) and each runs every multi-process
case; the tests hold what the ranks saw against the single-process port
in this process. The JAX parity of the data-parallel fit is held through
the single-process fit, which tests/test_torch_slice.py holds against the
JAX package's loss, gradients and Adam steps; JAX's sharded jit computes
the single-device function (tools/run_sharded_sepsis.py asserts it), so
the port's ranks must reproduce the single process: one step's loss within
1e-6 relative and its gradients within 1e-5 of their scale, every epoch's
train loss within 1e-4 relative and the test AUROC within 1e-3.
"""

import torch_threads  # noqa: F401  (one intra-op thread)

import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from snsde_torch.harness.classification import run_sepsis
from snsde_torch.parallel import (Mesh, batch_sharding, init_multihost,
                                  local_device_count, make_mesh,
                                  pad_to_multiple, replicate, replicated,
                                  shard_batch, shard_rows)

STEP_LOSS_RTOL = 1e-6
STEP_GRAD_TOL = 1e-5
EPOCH_LOSS_RTOL = 1e-4
AUROC_TOL = 1e-3


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn(R.parallel_rank, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def single_step():
    return R.sepsis_step()


@pytest.fixture(scope="module")
def single_fit():
    res = run_sepsis(R.sepsis_config(), n=R.DP["n"],
                     max_epochs=R.DP["epochs"], device="cpu")
    return R.fit_record(res)


def _step_errors(dp_ranks, single, key="step"):
    """(relative loss error, largest gradient error over its scale, the
    ranks' gradients equal) of a data-parallel step (the ranks' partial
    losses summed) against the single process's. A gradient's scale is its
    largest entry floored at 1e-3 of the model's largest gradient: the
    readout's first bias, which train-mode BatchNorm cancels, is 0 in truth
    and rounding noise on both sides (ROADMAP Queue 3's trap)."""
    loss = sum(r[key][0] for r in dp_ranks)
    rel = abs(loss - single[0]) / abs(single[0])
    top = max(float(g.abs().max()) for g in single[1].values())
    grad_err = max(float((dp_ranks[0][key][1][k] - g).abs().max())
                   / max(float(g.abs().max()), 1e-3 * top)
                   for k, g in single[1].items())
    same = all(torch.equal(dp_ranks[0][key][1][k], dp_ranks[1][key][1][k])
               for k in single[1])
    return rel, grad_err, same


def test_single_process_mesh_is_the_identity():
    mesh = make_mesh(("data",), devices="cpu")
    assert isinstance(mesh, Mesh)
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1} and mesh.device == torch.device("cpu")
    x = np.arange(6)
    np.testing.assert_array_equal(shard_batch(x, mesh), x)
    t = torch.arange(4.0)
    assert replicate(t, mesh) is t
    assert batch_sharding(mesh, 6) == slice(None) == replicated(mesh)
    assert init_multihost(None, 1, 0) is None
    assert local_device_count() >= 1
    two = make_mesh(("data", "model"), devices="cpu")
    assert two.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh(("data",), shape=(2,), devices="cpu")


def test_make_mesh_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh()


@pytest.mark.parametrize("n, multiple, expect", [(5, 4, 8), (8, 4, 8),
                                                 (1, 3, 3)])
def test_pad_to_multiple(n, multiple, expect):
    arr = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    padded, orig = pad_to_multiple(arr, multiple, value=-1.0)
    assert orig == n and padded.shape == (expect, 2)
    np.testing.assert_array_equal(padded[:n], arr)
    assert (padded[n:] == -1.0).all()


def test_ranks_join_over_gloo(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["size"] == 2 and r["backend"] == "gloo" for r in ranks)


def test_shard_batch_takes_the_ranks_rows(ranks):
    for r, rec in enumerate(ranks):
        sh = rec["shard_even"]
        np.testing.assert_array_equal(sh["a"], np.arange(8)[4 * r:4 * r + 4])
        assert torch.equal(sh["t"], torch.arange(12).reshape(4, 3)[2 * r:
                                                                  2 * r + 2])
        assert sh["s"] == np.float32(3.0)       # a 0-d leaf stays whole


def test_replicate_broadcasts_rank_0(ranks):
    for rec in ranks:
        assert torch.equal(rec["replicate_tensor"], torch.zeros(3))
        assert torch.equal(rec["replicate_module"], torch.ones(2, 3))


def _close(a, ref, tol=1e-6):
    """Within tol of max(1, the reference's largest entry)."""
    bound = tol * max(1.0, float(ref.abs().max()))
    assert float((a - ref).abs().max()) <= bound, (a, ref)


@pytest.mark.parametrize("three_d", [False, True])
def test_global_batchnorm_matches_whole_batch(ranks, three_d):
    """W=2 halves through the global BatchNorm against torch's BatchNorm1d
    on the whole batch: output, input gradient, the summed weight and bias
    gradients and the running statistics, to 1e-6 of max(1, the
    reference's largest entry)."""
    x, dy = R.bn_inputs(three_d)
    x = x.clone().requires_grad_(True)
    ref = R.bn_module()
    y_ref = torch.nn.BatchNorm1d.forward(ref, x)
    y_ref.backward(dy)
    parts = [rec["bn"][three_d] for rec in ranks]
    _close(torch.cat([p["y"] for p in parts]), y_ref.detach())
    _close(torch.cat([p["dx"] for p in parts]), x.grad)
    _close(parts[0]["dw"] + parts[1]["dw"], ref.weight.grad)
    _close(parts[0]["db"] + parts[1]["db"], ref.bias.grad)
    for p in parts:
        _close(p["running_mean"], ref.running_mean)
        _close(p["running_var"], ref.running_var)


def test_dp_step_matches_single_process(ranks, single_step):
    rel, grad_err, same = _step_errors(ranks, single_step)
    assert rel < STEP_LOSS_RTOL, rel
    assert grad_err < STEP_GRAD_TOL, grad_err
    assert same
    for k, p in single_step[2].items():
        torch.testing.assert_close(ranks[0]["step"][2][k], p, atol=1e-6,
                                   rtol=0)
        assert torch.equal(ranks[0]["step"][2][k], ranks[1]["step"][2][k])


@pytest.mark.parametrize("key", ["step_local_bn", "step_local_noise"])
def test_dp_step_needs_global_batchnorm_and_noise(ranks, single_step, key):
    """The same step with BatchNorm's statistics taken over each rank's
    rows alone, or with each rank drawing the noise of its own shape,
    leaves the single process's step by far more than the bars."""
    rel, grad_err, _ = _step_errors(ranks, single_step, key)
    assert rel > 100 * STEP_LOSS_RTOL or grad_err > 100 * STEP_GRAD_TOL, (
        rel, grad_err)


def test_known_fault_shard_batch_replicates_uneven_batch(ranks):
    """The JAX package's shard_batch silently replicates a leaf whose
    leading dimension does not divide by the mesh (snsde/parallel/mesh.py:68,
    a known fault): the port keeps it, so a batch of 31 on two ranks is
    whole on each, and the step is the single process's, bit for bit."""
    for rec in ranks:
        np.testing.assert_array_equal(rec["shard_uneven"], np.arange(7))
        np.testing.assert_array_equal(rec["uneven_shard"],
                                      np.arange(R.DP["uneven_batch"]))
    loss, grads, params = R.sepsis_step(batch=R.DP["uneven_batch"])
    for rec in ranks:
        assert rec["step_uneven"][0] == loss
        for k in grads:
            assert torch.equal(rec["step_uneven"][1][k], grads[k])
            assert torch.equal(rec["step_uneven"][2][k], params[k])


def test_dp_fit_matches_single_process(ranks, single_fit):
    fit = ranks[0]["fit"]
    assert len(fit["history"]) == len(single_fit["history"]) == R.DP["epochs"]
    for h, s in zip(fit["history"], single_fit["history"]):
        a, b = h["train"]["loss"], s["train"]["loss"]
        assert abs(a - b) <= EPOCH_LOSS_RTOL * abs(b), (a, b)
    assert abs(fit["test"]["auroc"] - single_fit["test"]["auroc"]) \
        <= AUROC_TOL
    for k, v in single_fit["state"].items():
        if v.is_floating_point():
            torch.testing.assert_close(fit["state"][k], v, atol=1e-4,
                                       rtol=1e-4)


def test_dp_fit_ranks_agree(ranks):
    a, b = ranks[0]["fit"], ranks[1]["fit"]
    assert a["history"] == b["history"]
    assert a["test"] == b["test"] and a["val"] == b["val"]
    assert a["memory_usage"] is None          # no CUDA allocator here
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


def test_row_shard_is_a_no_op_for_one_process():
    from snsde_torch.parallel import active_shard, draw_rows

    mesh = make_mesh(devices="cpu")
    with shard_rows(mesh, 8) as shard:
        assert shard is None and active_shard() is None
        g = torch.Generator().manual_seed(0)
        t = draw_rows(lambda s: torch.randn(s, generator=g), (4, 3))
    assert t.shape == (4, 3)
