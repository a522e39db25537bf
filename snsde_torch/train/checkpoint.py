"""Checkpoints of the port (counterpart of snsde/train/checkpoint.py).

The layout is the JAX package's: directory/step_{n}/<name>.* plus
meta.json with the step and the sorted names. What is saved is the
port's own: each object's `state_dict()` (a module's parameters and
buffers, an optimizer's moments, step counts and parameter groups) in
torch's format, `<name>.pt`. Nothing reads or writes the JAX package's
`.npz` leaves.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_state", "load_state", "save_checkpoint", "latest_step",
           "load_checkpoint"]


def save_state(path: str, obj) -> None:
    """Write obj.state_dict() (a module or an optimizer) to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(obj.state_dict(), path)


def load_state(path: str, like):
    """Load the state written by save_state into `like` in place (tensors
    onto its parameters' device) and return it."""
    like.load_state_dict(torch.load(path, map_location="cpu",
                                    weights_only=True))
    return like


def save_checkpoint(directory: str, step: int, **objs) -> str:
    """Save each named object's state under directory/step_{step}/."""
    loc = os.path.join(directory, f"step_{step}")
    os.makedirs(loc, exist_ok=True)
    for name, obj in objs.items():
        save_state(os.path.join(loc, name + ".pt"), obj)
    with open(os.path.join(loc, "meta.json"), "w") as f:
        json.dump({"step": step, "names": sorted(objs)}, f)
    return loc


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def load_checkpoint(directory: str, like: Dict[str, Any], step=None):
    """Load the named states into `like`'s objects (name -> module or
    optimizer) in place; returns ({name: object}, step). Raises
    FileNotFoundError when the directory holds no step."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    loc = os.path.join(directory, f"step_{step}")
    return {name: load_state(os.path.join(loc, name + ".pt"), obj)
            for name, obj in like.items()}, step
