"""Statistical comparison of models: Friedman test, pairwise Wilcoxon with
Holm correction, critical-difference diagram data (the port's own copy of
snsde/analysis.py, which the port does not import).

Rebuilds the analysis layer of the reference torch-ists function.py:
25-384 (Friedman + Wilcoxon-Holm + clique construction for CD diagrams).
Returns plain data structures; the matplotlib rendering is a thin optional
layer (`plot_cd_diagram`, which imports matplotlib when called).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy import stats as _scipy_stats

__all__ = ["friedman_test", "wilcoxon_holm", "average_ranks",
           "cd_cliques", "cd_analysis", "CDResult", "plot_cd_diagram"]


def average_ranks(scores: np.ndarray) -> np.ndarray:
    """scores [n_datasets, n_models] (higher better) -> mean rank per model
    (rank 1 = best)."""
    n_d, n_m = scores.shape
    ranks = np.zeros_like(scores, dtype=np.float64)
    for i in range(n_d):
        order = (-scores[i]).argsort(kind="mergesort")
        r = np.empty(n_m, np.float64)
        sorted_vals = scores[i][order]
        j = 0
        pos = np.arange(1, n_m + 1, dtype=np.float64)
        while j < n_m:
            k = j
            while k + 1 < n_m and sorted_vals[k + 1] == sorted_vals[j]:
                k += 1
            r[order[j : k + 1]] = pos[j : k + 1].mean()
            j = k + 1
        ranks[i] = r
    return ranks.mean(axis=0)


def friedman_test(scores: np.ndarray) -> Tuple[float, float]:
    """Friedman chi-square test over [n_datasets, n_models] scores.
    Returns (statistic, p_value)."""
    res = _scipy_stats.friedmanchisquare(*scores.T)
    return float(res.statistic), float(res.pvalue)


def wilcoxon_holm(scores: np.ndarray, model_names: List[str],
                  alpha: float = 0.05) -> List[Dict]:
    """All pairwise Wilcoxon signed-rank tests with Holm step-down
    correction. Returns list of {pair, p_value, reject}."""
    n_m = scores.shape[1]
    pairs = []
    for i in range(n_m):
        for j in range(i + 1, n_m):
            d = scores[:, i] - scores[:, j]
            if np.all(d == 0):
                p = 1.0
            else:
                try:
                    p = float(
                        _scipy_stats.wilcoxon(
                            scores[:, i], scores[:, j],
                            zero_method="pratt",
                        ).pvalue
                    )
                except ValueError:
                    p = 1.0
            pairs.append(
                {"pair": (model_names[i], model_names[j]), "p_value": p}
            )
    # Holm step-down
    m = len(pairs)
    order = np.argsort([p["p_value"] for p in pairs])
    reject = [False] * m
    for rank, idx in enumerate(order):
        threshold = alpha / (m - rank)
        if pairs[idx]["p_value"] <= threshold:
            reject[idx] = True
        else:
            break  # Holm stops at first non-rejection
    for i, p in enumerate(pairs):
        p["reject"] = reject[i]
    return pairs


def cd_cliques(scores: np.ndarray, model_names: List[str],
               alpha: float = 0.05) -> List[List[str]]:
    """Maximal cliques of models NOT significantly different (the bars of a
    CD diagram). Greedy interval construction on the rank ordering, like
    the reference's networkx-clique approach but without the dependency."""
    pairs = wilcoxon_holm(scores, model_names, alpha)
    not_diff = {
        frozenset(p["pair"]) for p in pairs if not p["reject"]
    }
    ranks = average_ranks(scores)
    order = np.argsort(ranks)
    names_sorted = [model_names[i] for i in order]
    cliques: List[List[str]] = []
    n = len(names_sorted)
    for i in range(n):
        group = [names_sorted[i]]
        for j in range(i + 1, n):
            cand = names_sorted[j]
            if all(frozenset((g, cand)) in not_diff for g in group):
                group.append(cand)
            else:
                break
        if len(group) > 1 and not any(
            set(group) <= set(c) for c in cliques
        ):
            cliques.append(group)
    return cliques


@dataclass
class CDResult:
    model_names: List[str]
    avg_ranks: np.ndarray
    friedman_stat: float
    friedman_p: float
    pairwise: List[Dict]
    cliques: List[List[str]]


def cd_analysis(scores: np.ndarray, model_names: List[str],
                alpha: float = 0.05) -> CDResult:
    """Average ranks, the Friedman test, the Holm-corrected pairwise
    Wilcoxon tests and the CD cliques of [n_datasets, n_models] scores."""
    stat, p = friedman_test(scores)
    return CDResult(
        model_names=model_names,
        avg_ranks=average_ranks(scores),
        friedman_stat=stat,
        friedman_p=p,
        pairwise=wilcoxon_holm(scores, model_names, alpha),
        cliques=cd_cliques(scores, model_names, alpha),
    )


def plot_cd_diagram(result: CDResult, path: Optional[str] = None):
    """Render a critical-difference diagram (optional matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    order = np.argsort(result.avg_ranks)
    names = [result.model_names[i] for i in order]
    ranks = result.avg_ranks[order]
    fig, ax = plt.subplots(figsize=(8, 0.4 * len(names) + 1.5))
    ax.scatter(ranks, range(len(names)))
    for i, (n, r) in enumerate(zip(names, ranks)):
        ax.annotate(f"{n} ({r:.2f})", (r, i), textcoords="offset points",
                    xytext=(5, 0))
    y = len(names)
    for clique in result.cliques:
        rs = [result.avg_ranks[result.model_names.index(c)] for c in clique]
        ax.plot([min(rs), max(rs)], [y, y], lw=3)
        y += 0.5
    ax.set_xlabel("average rank (lower is better)")
    ax.set_yticks([])
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=120)
    return fig
