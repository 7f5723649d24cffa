"""Elastic scaling and fault tolerance (the reference's
`training/elastic.py`), on one card.

`best_mesh_shape`, `StepWatchdog` and `run_with_restarts` are the
reference's.  The reference builds a (data, model) mesh from the
surviving devices and re-places a restored tree on it; the port runs on
one card, so `make_elastic_mesh` describes the one-device mesh and
`reshard` moves a (host) tree to that device.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import device as _device
from .. import tree as _tree


def best_mesh_shape(n_devices: int, model_parallel: int) -> tuple[int, int]:
    """Largest (data, model) grid with the requested TP degree that fits."""
    model = math.gcd(model_parallel, n_devices)
    while model > 1 and n_devices % model:
        model -= 1
    return max(n_devices // model, 1), max(model, 1)


@dataclass(frozen=True)
class Mesh:
    """A (data, model) grid of devices: on one card, (1, 1)."""
    shape: tuple
    axis_names: tuple
    device: torch.device


def make_elastic_mesh(model_parallel: int = 16, device="cuda") -> Mesh:
    """The mesh of the devices there are: one, `device`."""
    return Mesh(best_mesh_shape(1, model_parallel), ("data", "model"),
                _device.resolve(device))


def reshard(tree: Any, device="cuda") -> Any:
    """A (host or device) tree on `device`: tensors of each leaf's dtype
    (numpy leaves become tensors)."""
    dev = _device.resolve(device)
    return _tree.map(lambda a: (a if isinstance(a, torch.Tensor)
                                else torch.from_numpy(np.asarray(a)))
                     .to(dev), tree)


@dataclass
class StepWatchdog:
    """Flags straggling steps: anything slower than `factor` x the median
    of the trailing window is reported."""
    factor: float = 3.0
    window: int = 50
    times: list = field(default_factory=list)
    slow_steps: list = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        dt = time.monotonic() - self._t0
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = sorted(hist)[len(hist) // 2]
        slow = len(hist) >= 5 and dt > self.factor * med
        if slow:
            self.slow_steps.append((step, dt, med))
        return slow


def run_with_restarts(step_fn: Callable[[int], Any], start_step: int,
                      n_steps: int, max_restarts: int = 3,
                      on_failure: Callable[[int, Exception], int] = None):
    """Driver loop: a step that raises triggers restore-and-continue;
    `on_failure(step, exc) -> resume_step` restores (typically from the
    last checkpoint).  Returns (the step reached, restarts)."""
    step = start_step
    restarts = 0
    while step < n_steps:
        try:
            step_fn(step)
            step += 1
        except Exception as exc:  # noqa: BLE001 - node failure surface
            restarts += 1
            if restarts > max_restarts or on_failure is None:
                raise
            step = on_failure(step, exc)
    return step, restarts
