"""Typed configuration tree (counterpart of snsde/configs.py): one
dataclass per harness and `ExperimentConfig` composing them, each round
trip through JSON and through dotted-key argv (`from_args`). The fields
are the JAX package's, so a JSON written by either package loads in the
other.

    python -m snsde_torch.configs --task sepsis \\
        --classification.model_name neuralgsde --n_samples 1024 \\
        --classification.max_epochs 2 [--device cpu]

`run` dispatches on `task` (sepsis | speech | mujoco | interpolation |
sweep); the device is a keyword of `run` (and `--device` of the command),
not a config field: CUDA by default, raising without it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional

from .harness.classification import HarnessConfig
from .harness.forecasting import ForecastConfig
from .harness.interpolation import InterpolationConfig
from .harness.robustness import SweepConfig

__all__ = ["ExperimentConfig", "to_json", "from_json", "from_args", "run",
           "main", "HarnessConfig", "ForecastConfig", "InterpolationConfig",
           "SweepConfig"]


@dataclass
class ExperimentConfig:
    task: str = "sepsis"          # sepsis|speech|mujoco|interpolation|sweep
    seed: int = 0
    n_samples: int = 4096
    results_dir: Optional[str] = None
    classification: HarnessConfig = field(default_factory=HarnessConfig)
    forecasting: ForecastConfig = field(default_factory=ForecastConfig)
    interpolation: InterpolationConfig = field(
        default_factory=InterpolationConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)


def to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg), indent=2, default=list)


def _merge(dc, data: dict):
    """dc with the entries of `data` that name its fields (nested
    dataclasses merged, JSON lists made tuples where the default is one);
    other keys are ignored, as in JAX."""
    kwargs = {}
    for f in dataclasses.fields(dc):
        if f.name not in data:
            continue
        v = data[f.name]
        cur = getattr(dc, f.name, None)
        if dataclasses.is_dataclass(cur):
            v = _merge(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return dataclasses.replace(dc, **kwargs)


def from_json(text: str) -> ExperimentConfig:
    return _merge(ExperimentConfig(), json.loads(text))


def from_args(argv) -> ExperimentConfig:
    """Dotted-key overrides: --task sepsis --classification.model_name
    neuralgsde --forecasting.lr 3e-4 ...; each value parsed as JSON, else
    kept as a string."""
    data: dict = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"unexpected argument {arg!r}")
        if i + 1 >= len(argv):
            raise ValueError(f"{arg} needs a value")
        parts = arg[2:].split(".")
        value = argv[i + 1]
        i += 2
        node = data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        try:
            node[parts[-1]] = json.loads(value)
        except json.JSONDecodeError:
            node[parts[-1]] = value
    return _merge(ExperimentConfig(), data)


def run(cfg: ExperimentConfig, *, device=None):
    """Run the experiment `cfg.task` on `device` (CUDA by default) with the
    config's seed (and, for sepsis and speech, its results_dir) put into
    the harness's config, as the JAX package's run does."""
    if cfg.task in ("sepsis", "speech"):
        from .harness.classification import run_sepsis, run_speech

        c = dataclasses.replace(cfg.classification, seed=cfg.seed,
                                results_dir=cfg.results_dir)
        fn = run_sepsis if cfg.task == "sepsis" else run_speech
        return fn(c, n=cfg.n_samples, device=device)
    if cfg.task == "mujoco":
        from .harness.forecasting import run_mujoco

        c = dataclasses.replace(cfg.forecasting, seed=cfg.seed)
        return run_mujoco(c, n=cfg.n_samples, device=device)
    if cfg.task == "interpolation":
        from .harness.interpolation import run_interpolation

        c = dataclasses.replace(cfg.interpolation, seed=cfg.seed)
        return run_interpolation(c, n=cfg.n_samples, device=device)
    if cfg.task == "sweep":
        from .harness.robustness import run_robustness_sweep

        return run_robustness_sweep(cfg.sweep, n=cfg.n_samples,
                                    device=device)
    raise ValueError(f"unknown task {cfg.task!r}")


def main(argv=None):
    """The command: `--device DEV` (optional) and the dotted-key overrides
    of `from_args`."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise ValueError("--device needs a value")
        device = argv[i + 1]
        del argv[i:i + 2]
    return run(from_args(argv), device=device)


if __name__ == "__main__":
    main()
