"""The port's copy of the flagship quality pins (snsde_torch/train/pins.py)
on every case of tests/test_pins.py, each run on both packages' pins so
the copy cannot drift from the JAX package's; plus the known fault of the
reference it keeps (ROADMAP "Known faults in the reference itself")."""

import torch_threads  # noqa: F401  (one intra-op thread)

import math

import numpy as np
import pytest

import snsde.train.pins as jax_pins
import snsde_torch.train.pins as port_pins

PINS = [pytest.param(port_pins, id="port"), pytest.param(jax_pins, id="jax")]


def _hist(losses, accs):
    return [{"epoch": i,
             "train": {"loss": lo, "accuracy": a},
             "val": {"loss": lo, "accuracy": a}}
            for i, (lo, a) in enumerate(zip(losses, accs))]


@pytest.mark.parametrize("pins", PINS)
def test_pins_fail_on_r4_speech_divergence(pins):
    losses = [2.3, 2.0, 1.8, 1.7, 1.6, 1.5, 1.44,
              2.94, 4.90, 6.55, 8.27, 9.40]
    accs = [0.1, 0.2, 0.3, 0.35, 0.4, 0.45, 0.50,
            0.35, 0.12, 0.11, 0.10, 0.10]
    res = pins.check_history(_hist(losses, accs), pins.FLAGSHIP_PINS["speech"])
    assert not res["ok"]
    assert any("climb" in v for v in res["violations"])
    with pytest.raises(AssertionError, match="climb"):
        pins.assert_pins(_hist(losses, accs), "speech")


@pytest.mark.parametrize("pins", PINS)
def test_pins_pass_on_healthy_run(pins):
    losses = list(np.linspace(2.3, 0.4, 20))
    accs = list(np.linspace(0.1, 0.92, 20))
    res = pins.check_history(_hist(losses, accs), pins.FLAGSHIP_PINS["speech"])
    assert res["ok"], res["violations"]
    assert res["best_metric"] > 0.9


@pytest.mark.parametrize("pins", PINS)
def test_pins_catch_nonfinite_and_floor(pins):
    losses = [2.0, 1.5, float("nan"), 1.2]
    accs = [0.1, 0.2, 0.25, 0.3]
    res = pins.check_history(_hist(losses, accs), pins.FLAGSHIP_PINS["speech"])
    assert not res["ok"]
    assert any("non-finite" in v for v in res["violations"])
    assert any("floor" in v for v in res["violations"])


@pytest.mark.parametrize("pins", PINS)
def test_pins_warmup_exempts_early_noise(pins):
    losses = [10.0, 35.0, 3.0, 2.0, 1.5, 1.2]
    accs = [0.1, 0.1, 0.3, 0.5, 0.6, 0.7]
    spec = pins.PinSpec(metric="accuracy", floor=0.4, warmup=3)
    assert pins.check_history(_hist(losses, accs), spec)["ok"]


@pytest.mark.parametrize("pins", PINS)
def test_pins_flat_history_keys(pins):
    hist = [{"epoch": i, "train_loss": 2.0 - 0.1 * i,
             "val_accuracy": 0.1 + 0.05 * i} for i in range(10)]
    spec = pins.PinSpec(metric="accuracy", floor=0.3)
    res = pins.check_history(hist, spec)
    assert res["ok"], res["violations"]


@pytest.mark.parametrize("pins", PINS)
def test_pins_allow_recovered_transient_bump(pins):
    losses = [5.0, 3.0, 2.4, 2.2, 1.5, 1.0, 0.7, 0.5, 0.32,
              0.9, 1.66, 0.8, 0.4, 0.3, 0.25]
    accs = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.85,
            0.7, 0.6, 0.8, 0.9, 0.95, 0.97]
    res = pins.check_history(_hist(losses, accs), pins.FLAGSHIP_PINS["speech"])
    assert res["ok"], res["violations"]


@pytest.mark.parametrize("pins", PINS)
def test_pins_min_mode_ceiling(pins):
    hist = [{"epoch": i, "train": 0.5 - 0.04 * i, "val": 0.5 - 0.04 * i}
            for i in range(10)]
    spec = pins.PinSpec(metric="mse", mode="min", ceiling=0.2)
    res = pins.check_history(hist, spec)
    assert res["ok"], res["violations"]
    assert res["best_metric"] == pytest.approx(0.5 - 0.04 * 9)
    flat = [{"epoch": i, "train": 0.5, "val": 0.5} for i in range(10)]
    res = pins.check_history(flat, spec)
    assert not res["ok"]
    assert any("ceiling" in v for v in res["violations"])


@pytest.mark.parametrize("pins", PINS)
def test_pins_mujoco_interpolation_ceilings_live(pins):
    for name, healthy, bad in (("mujoco", 0.024, 0.5),
                               ("interpolation", 0.069, 0.9)):
        spec = pins.FLAGSHIP_PINS[name]
        good = [{"epoch": i, "train": healthy * (3 - 0.02 * i),
                 "val": healthy * (3 - 0.02 * i)} for i in range(101)]
        res = pins.check_history(good, spec)
        assert res["ok"], (name, res["violations"])
        stuck = [{"epoch": i, "train": bad, "val": bad} for i in range(20)]
        res = pins.check_history(stuck, spec)
        assert not res["ok"], name


def test_the_copy_has_the_jax_packages_pins():
    """The same flagships with the same thresholds."""
    assert set(port_pins.FLAGSHIP_PINS) == set(jax_pins.FLAGSHIP_PINS)
    for name, spec in jax_pins.FLAGSHIP_PINS.items():
        assert vars(port_pins.FLAGSHIP_PINS[name]) == vars(spec), name


@pytest.mark.parametrize("pins", PINS)
def test_known_fault_min_mode_sees_no_interpolation_mse(pins):
    """A KNOWN FAULT of the reference, kept in the copy and named here,
    not approved: the interpolation harness's history
    (snsde/harness/interpolation.py:309) carries its per-epoch elbo but no
    validation MSE, so the min-mode ceiling (pins.py:134) finds no value,
    takes best = inf and fails a healthy run. The port's interpolation
    harness (snsde_torch/harness/interpolation.py) writes JAX's history as
    it is, so the fault stays, named here."""
    healthy = [{"iter": i, "elbo": -2.0 + 0.01 * i, "logpx": -1.9,
                "kl": 0.1, "kl_coef": 1.0} for i in range(30)]
    res = pins.check_history(healthy, pins.FLAGSHIP_PINS["interpolation"])
    assert math.isinf(res["best_metric"])
    assert not res["ok"]
    assert any("ceiling" in v for v in res["violations"])
