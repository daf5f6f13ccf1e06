"""Checkpointing: npz + JSON manifest, atomic, retained, placed on any
device at restore, optional takum compression, preemption hook, async
save.

The port's copy of the JAX package's ``checkpoint/manager.py``, with the
same files and the same contract:

* **atomic**: writes go to ``<dir>/.tmp-<step>`` then ``os.replace`` onto
  ``step_<n>``: a crash mid-save never corrupts the latest checkpoint;
* **restart**: ``latest_step`` + the stateless data pipeline -> exact
  resume;
* **placement**: arrays are stored whole; ``restore(..., device=)`` puts
  every leaf on that device (the reference's ``sharding_fn``), None
  keeps host (numpy) arrays;
* **preemption**: ``PreemptionGuard`` turns SIGTERM into a save at the
  next step boundary;
* **codec compression**: with ``codec="takum16"``, f32/f64 leaves travel
  as takum words, rounded by the port's own codec (the reference's words
  for the same floats, bit for bit).

Leaves are torch tensors (any device) or numpy arrays, named by their
path as the reference names them (``['params']/['layers']/[0]/...``).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import takum as takum_mod
from repro_torch.core.bitops import carrier
from repro_torch.tree import (leaves_with_paths, path_name, tree_flatten,
                              tree_map, tree_unflatten)

__all__ = ["save", "restore", "latest_step", "CheckpointManager",
           "PreemptionGuard"]

_MANIFEST = "manifest.json"


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (uint16 words keep their bits)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        raise TypeError("bf16 leaves have no numpy dtype: checkpoint f32 "
                        "parameters")
    arr = (carrier(t).numpy().view(np.uint16) if t.dtype == torch.uint16
           else t.numpy())
    return arr if leaf.is_cuda else arr.copy()   # never alias a CPU leaf


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.uint16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _leaf_paths(tree):
    pairs = leaves_with_paths(tree)
    return [path_name(p) for p, _ in pairs], [leaf for _, leaf in pairs]


def save(step: int, tree: Any, directory: str, *, codec: str = "none",
         keep: int = 3) -> str:
    """Atomic checkpoint save; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{step}")
    final = os.path.join(directory, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    names, leaves = _leaf_paths(tree)
    manifest = {"step": step, "codec": codec, "leaves": []}
    arrays = {}
    for i, (name, leaf) in enumerate(zip(names, leaves)):
        arr = _to_numpy(leaf)
        entry = {"name": name, "dtype": str(arr.dtype),
                 "shape": list(arr.shape), "key": f"a{i}", "codec": "none"}
        if codec.startswith("takum") and arr.dtype in (np.float32,
                                                       np.float64):
            n = int(codec[len("takum"):])
            words = takum_mod.float_to_takum(
                torch.from_numpy(arr.astype(np.float32)), n)
            arrays[f"a{i}"] = _to_numpy(words)
            entry["codec"] = codec
        else:
            arrays[f"a{i}"] = arr
        manifest["leaves"].append(entry)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "treedef.txt"), "w") as f:
        f.write(str(tree_flatten(tree)[1]))
    os.replace(tmp, final)
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int):
    steps = sorted(_all_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def _all_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for d in os.listdir(directory):
        if d.startswith("step_"):
            out.append(int(d[len("step_"):]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _all_steps(directory)
    return max(steps) if steps else None


def restore(directory: str, template: Any, *, step: Optional[int] = None,
            device=None):
    """Restore into the structure of ``template``: (tree, step). With
    ``device`` every leaf is a tensor there; None keeps numpy arrays."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))

    names, _ = _leaf_paths(template)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    out = []
    for name in names:
        e = by_name[name]
        arr = data[e["key"]]
        if e["codec"].startswith("takum"):
            n = int(e["codec"][len("takum"):])
            arr = takum_mod.takum_to_float(_to_tensor(arr, "cpu"),
                                           n).numpy().astype(e["dtype"])
        arr = arr.astype(np.dtype(e["dtype"]))
        out.append(arr if device is None else _to_tensor(arr, device))
    return tree_unflatten(tree_flatten(template)[1], out), manifest["step"]


class PreemptionGuard:
    """SIGTERM -> request a save at the next step boundary."""

    def __init__(self):
        self.requested = threading.Event()
        self._old = {}
        for sig in (signal.SIGTERM,):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # non-main thread

    def _handler(self, signum, frame):
        self.requested.set()

    def should_save(self) -> bool:
        return self.requested.is_set()


class CheckpointManager:
    """Retention + async save + preemption handling around save/restore."""

    def __init__(self, directory: str, *, keep: int = 3,
                 codec: str = "none", save_interval: int = 100):
        self.directory = directory
        self.keep = keep
        self.codec = codec
        self.save_interval = save_interval
        self.guard = PreemptionGuard()
        self._pending: Optional[threading.Thread] = None

    def maybe_save(self, step: int, tree: Any, *, force: bool = False):
        if not (force or self.guard.should_save()
                or (step > 0 and step % self.save_interval == 0)):
            return False
        self.wait()
        host_tree = tree_map(_to_numpy, tree)  # snapshot

        def _bg():
            save(step, host_tree, self.directory, codec=self.codec,
                 keep=self.keep)

        self._pending = threading.Thread(target=_bg, daemon=False)
        self._pending.start()
        self.guard.requested.clear()
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, template, device=None):
        return restore(self.directory, template, device=device)
