"""Atomic, resumable checkpointing (the reference's
`training/checkpoint.py`), with its on-disk layout:

    <dir>/step_<N>/index.json   the step, a description of the tree, and
                                each leaf's shape and dtype
    <dir>/step_<N>/leaf_<i>.npy one numpy file per leaf

Leaves are numbered in `jax.tree`'s flatten order (`repro_torch.tree`:
dict values by sorted key), so a checkpoint either package writes
restores in the other.  A save writes a temporary directory, fsyncs the
index and renames it into place, so a preemption mid-save never leaves a
partial latest step.  `AsyncCheckpointer` copies the tree to the host
when a save is submitted and writes it on a background thread.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import tree as _tree


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (bfloat16, which numpy lacks, as float32;
    `restore` casts back to the structure's dtype)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(x) for x in tree)
        return f"({inner})" if isinstance(tree, tuple) else f"[{inner}]"
    return "*"


def save(path, tree, step: int) -> Path:
    """Atomic synchronous save; returns the final step dir."""
    base = Path(path)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    index = {"step": step, "treedef": _describe(tree), "leaves": []}
    for i, leaf in enumerate(_tree.leaves(tree)):
        arr = _host(leaf)
        np.save(tmp / f"leaf_{i}.npy", arr)
        index["leaves"].append({"i": i, "shape": list(arr.shape),
                                "dtype": str(arr.dtype)})
    (tmp / "index.json").write_text(json.dumps(index))
    with open(tmp / "index.json", "r+") as f:
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(path) -> Optional[int]:
    """The newest complete step under `path`, or None."""
    base = Path(path)
    if not base.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in base.iterdir()
             if d.name.startswith("step_") and (d / "index.json").exists()]
    return max(steps) if steps else None


def restore(path, like, step: int | None = None) -> tuple:
    """(tree, step): the checkpoint at `step` (default the latest) in the
    structure of `like`, each leaf a tensor with the dtype and on the
    device of `like`'s leaf (a non-tensor leaf of `like` gets the numpy
    array)."""
    base = Path(path)
    if step is None:
        step = latest_step(base)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {base}")
    d = base / f"step_{step:08d}"
    out = []
    for i, leaf in enumerate(_tree.leaves(like)):
        arr = np.load(d / f"leaf_{i}.npy")
        if isinstance(leaf, torch.Tensor):
            arr = torch.from_numpy(arr).to(device=leaf.device,
                                           dtype=leaf.dtype)
        out.append(arr)
    return _tree.unflatten(like, out), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer (non-blocking saves), keeping
    the newest `keep` steps."""

    def __init__(self, path, keep: int = 3):
        self.path = Path(path)
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self.last_saved: Optional[int] = None

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            save(self.path, tree, step)
            self.last_saved = step
            self._gc()
            self._q.task_done()

    def _gc(self):
        steps = sorted(d for d in self.path.iterdir()
                       if d.name.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    def submit(self, tree, step: int):
        """Copy `tree` to the host now (training may then overwrite it)
        and queue its save."""
        self._q.put((_tree.map(_host, tree), step))

    def wait(self):
        self._q.join()

    def close(self):
        self._q.put(None)
        self._thread.join()
