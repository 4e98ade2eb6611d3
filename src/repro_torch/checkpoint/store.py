"""Checkpointing: atomic, async, restore onto a given device (the JAX
package's ``checkpoint/store.py``, in its layout).

Layout:  <dir>/step_<N>/
             manifest.json       (keys + extra state)
             arrays.npz          (flattened leaves, key = tree path)
         <dir>/LATEST            (atomic pointer file)

* A tree is nested dicts, lists and tuples whose leaves are tensors or
  numpy arrays; an ``nn.Module`` stands for its ``state_dict()`` and an
  ``AdamWState`` for its fields (``mu``, ``nu``, ``step``).  Keys join
  the path with "/" (``params/blocks.0.attn.wq``, ``opt/mu/...``).
* bf16 leaves are widened to f32 on disk (npz has no bf16; the widening
  is exact) and narrowed back on restore.
* ``CheckpointManager.save_async`` copies every leaf to host memory
  before its thread starts (snapshot semantics: the train loop may
  update the tensors in place right after), joins the previous save
  before starting the next (bounded staleness of exactly one
  checkpoint) and keeps the last ``keep`` steps.
* Writes go to a temp dir + atomic rename and the ``LATEST`` pointer is
  replaced atomically, so a preemption mid-save never corrupts the
  latest checkpoint; a stray ``.tmp_step_*`` directory is never read.
* ``load_checkpoint`` restores into a given module (its parameters
  replaced, on the requested device) and rebuilds the other leaves
  there.  With ``shardings`` (a tree of DTensor placements, as
  ``launch.sharding.sharding_tree`` gives, and the ``mesh``) each leaf
  it names is placed as a DTensor: the reference's resharding restore.
  Checkpoints hold whole tensors, so one saved from any mesh (or none)
  restores onto any mesh.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


def _children(tree):
    """(key, child) pairs of an inner node; None for a leaf."""
    if isinstance(tree, nn.Module):
        return list(tree.state_dict().items())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return list(tree.items())
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (never a view of the caller's memory)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if hasattr(t, "full_tensor"):   # a DTensor: its whole value
            t = t.full_tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()               # npz has no bf16; exact
        return t.to("cpu", copy=True).numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    kids = _children(tree)
    if kids is None:
        return {prefix: _host(tree)}
    flat = {}
    for key, child in kids:
        flat.update(_flatten(child, _join(prefix, key)))
    return flat


def _write(directory: pathlib.Path, step: int, flat: dict,
           extra: dict | None) -> pathlib.Path:
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp_step_{step}_{time.time_ns()}"
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {"step": step, "keys": sorted(flat),
                "extra": extra or {}, "time": time.time()}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = directory / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    # atomic LATEST pointer
    ptr = directory / ".LATEST.tmp"
    ptr.write_text(str(step))
    ptr.rename(directory / "LATEST")
    return final


def save_checkpoint(directory: str | pathlib.Path, step: int, tree,
                    extra: dict | None = None) -> pathlib.Path:
    """Write ``tree`` as ``<directory>/step_<step>`` and point ``LATEST``
    at it; returns the step's directory."""
    return _write(pathlib.Path(directory), step, _flatten(tree), extra)


def latest_step(directory: str | pathlib.Path) -> int | None:
    ptr = pathlib.Path(directory) / "LATEST"
    if not ptr.exists():
        return None
    try:
        return int(ptr.read_text().strip())
    except ValueError:
        return None


def _sub(shardings, key):
    """The part of a shardings tree for child ``key`` (None: none)."""
    if shardings is None:
        return None
    if dataclasses.is_dataclass(shardings):
        return getattr(shardings, key, None)
    if isinstance(shardings, dict):
        return shardings.get(key)
    return shardings[key]


def _restore(tree, data, prefix: str, device, shardings=None, mesh=None):
    """``tree`` with every leaf read from ``data`` onto ``device`` in the
    leaf's dtype, placed by ``shardings`` on ``mesh`` where that names
    it; a module is filled in place and returned."""
    if isinstance(tree, nn.Module):
        state = {k: _restore(v, data, _join(prefix, k), device,
                             _sub(shardings, k), mesh)
                 for k, v in tree.state_dict().items()}
        tree.load_state_dict(state, strict=True, assign=True)
        return tree
    kids = _children(tree)
    if kids is None:
        arr = data[prefix]
        if isinstance(tree, torch.Tensor):
            t = torch.from_numpy(arr).to(device=device, dtype=tree.dtype)
            if shardings is not None:
                from torch.distributed.tensor import distribute_tensor
                t = distribute_tensor(t, mesh, shardings)
            return t
        return arr.astype(np.asarray(tree).dtype)
    out = {k: _restore(v, data, _join(prefix, k), device,
                       _sub(shardings, k), mesh) for k, v in kids}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**out)
    if isinstance(tree, dict):
        return out
    return type(tree)(out[i] for i in range(len(kids)))


def load_checkpoint(directory: str | pathlib.Path, tree,
                    step: int | None = None, *, device, shardings=None,
                    mesh=None) -> tuple[object, dict]:
    """Restore the checkpoint of ``step`` (default: ``LATEST``) into the
    structure of ``tree`` on ``device``: each leaf takes its dtype from
    ``tree`` (tensors on the meta device describe it without memory), a
    module's parameters are replaced by the stored ones.  ``shardings``
    is a tree shaped like ``tree`` (a module: {state-dict name:
    placements}; an ``AdamWState``: a dict of its fields) whose leaves
    are DTensor placements on ``mesh`` or None: each leaf it places is
    restored as a DTensor.  Returns (the restored tree, the saved
    ``extra``).  A key missing from the file raises ``KeyError``."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as data:
        restored = _restore(tree, data, "", torch.device(device),
                            shardings, mesh)
    return restored, manifest["extra"]


class CheckpointManager:
    """Async save + retention."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree, extra: dict | None = None,
                   write: bool = True):
        """Snapshot ``tree`` to host memory now and write it in a thread.
        Every rank of a sharded run calls it (a DTensor's whole value is
        gathered), and only the one given ``write`` writes."""
        self.wait()
        # copy to host memory BEFORE backgrounding (snapshot semantics)
        flat = _flatten(tree)
        if not write:
            return

        def work():
            _write(self.dir, step, flat, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
