"""snsde_torch.analysis (the port's copy of snsde/analysis.py) against the
JAX package's: average ranks, the Friedman test, the Holm-corrected
pairwise Wilcoxon tests, the CD cliques and cd_analysis, on seeded random
score tables (with ties) and on SWEEP_CD.json's accuracy table."""

import torch_threads  # noqa: F401  (one intra-op thread)

import json
import os

import numpy as np
import pytest

import snsde.analysis as jax_analysis
import snsde_torch.analysis as analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tables():
    rng = np.random.default_rng(0)
    out = {f"random {i}": rng.uniform(size=(12 + i, 4 + i % 3))
           for i in range(4)}
    # ties within and across rows, and one pair of identical models
    tied = np.round(rng.uniform(size=(15, 5)), 1)
    tied[:, 4] = tied[:, 3]
    out["tied"] = tied
    with open(os.path.join(ROOT, "SWEEP_CD.json")) as f:
        sweep = json.load(f)
    out["SWEEP_CD.json"] = np.asarray(sweep["accuracy"])
    return out, sweep["models"]


TABLES, SWEEP_MODELS = _tables()


def _names(scores):
    if scores.shape[1] == len(SWEEP_MODELS):
        return list(SWEEP_MODELS)
    return [f"m{j}" for j in range(scores.shape[1])]


@pytest.mark.parametrize("table", sorted(TABLES))
def test_every_function_matches_the_jax_package(table):
    scores = TABLES[table]
    names = _names(scores)
    np.testing.assert_array_equal(analysis.average_ranks(scores),
                                  jax_analysis.average_ranks(scores))
    assert analysis.friedman_test(scores) == jax_analysis.friedman_test(
        scores)
    assert analysis.wilcoxon_holm(scores, names) == \
        jax_analysis.wilcoxon_holm(scores, names)
    assert analysis.cd_cliques(scores, names) == jax_analysis.cd_cliques(
        scores, names)
    ours = analysis.cd_analysis(scores, names)
    theirs = jax_analysis.cd_analysis(scores, names)
    np.testing.assert_array_equal(ours.avg_ranks, theirs.avg_ranks)
    assert (ours.friedman_stat, ours.friedman_p, ours.pairwise,
            ours.cliques) == (theirs.friedman_stat, theirs.friedman_p,
                              theirs.pairwise, theirs.cliques)


def test_sweep_cd_table_reproduces_its_recorded_analysis():
    """On SWEEP_CD.json's accuracy table the port's analysis gives the
    file's own average ranks, Friedman statistic and p, pairwise tests and
    cliques (the JAX package's run that wrote it)."""
    with open(os.path.join(ROOT, "SWEEP_CD.json")) as f:
        sweep = json.load(f)
    res = analysis.cd_analysis(np.asarray(sweep["accuracy"]),
                               sweep["models"])
    np.testing.assert_allclose(res.avg_ranks, sweep["avg_ranks"], rtol=0,
                               atol=1e-12)
    assert res.friedman_stat == pytest.approx(sweep["friedman_stat"],
                                              rel=1e-12)
    assert res.friedman_p == pytest.approx(sweep["friedman_p"], rel=1e-12)
    assert [[list(p["pair"]), p["p_value"], p["reject"]]
            for p in res.pairwise] == [[p["pair"], p["p_value"],
                                        p["reject"]]
                                       for p in sweep["pairwise"]]
    assert res.cliques == sweep["cliques"]


def test_the_port_imports_neither_jax_nor_the_jax_package():
    """snsde_torch.analysis keeps its own copy: its source names no jax
    and no snsde module, and it imports without matplotlib."""
    src = open(analysis.__file__).read()
    assert "import jax" not in src and "from snsde" not in src
    assert "import snsde" not in src
    assert "import matplotlib" not in src.split("def plot_cd_diagram")[0]


def test_no_port_module_and_no_chip_script_imports_jax():
    """Every module of snsde_torch and chip_smoke.py: no import of jax and
    none of the JAX package (snsde_torch keeps its own copies)."""
    import os
    import re

    import snsde_torch

    root = os.path.dirname(os.path.dirname(
        os.path.abspath(snsde_torch.__file__)))
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(root, "snsde_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(root, "chip_smoke.py"))
    bad = re.compile(r"^\s*(import (jax|snsde)\b(?!_)|from (jax|snsde)"
                     r"(\.| import))", re.M)
    for path in files:
        with open(path) as f:
            hits = bad.findall(f.read())
        assert not hits, (path, hits)
    assert len(files) > 30
