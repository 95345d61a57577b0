"""Fault-tolerant checkpointing: atomic, async-capable.

Port of ``repro.checkpoint.store``, with its layout: ``<dir>/step_<N>/``
holds one ``.npy`` per leaf (``leaf_00000.npy`` ...) and a
``manifest.json`` with the step, the leaf count, the tree's structure and
``extra``.  A save writes ``step_<N>.tmp`` and publishes it with
``os.replace`` only when complete, so a preemption mid-save never corrupts
the latest checkpoint; ``keep`` bounds how many are kept.

A tree is nested dicts (keys taken in sorted order, as the reference's
flattening takes them), lists and tuples of tensors.  numpy has no
bfloat16, so a bf16 tensor is saved as its uint16 bits and its dtype named
in the manifest's ``dtypes`` (the inverse of ``models.convert._tensor``).
A restore copies each leaf into the live tensor of ``like_tree`` in the
same order.

Sharded state (elastic re-sharding): a leaf that is a DTensor is saved
whole (its pieces all-gathered, every rank taking part) and written by
rank 0 alone; a restore with ``shardings`` (a tree of
``sharding.Layout``s mirroring ``like_tree``, or a DTensor's own
placements) reads each rank's piece of the whole array for the mesh it
runs on now, so a checkpoint saved by n ranks restores onto m.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.sharding import Layout, full


def _flatten(tree, path: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, leaf) in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, f"{path}/{i}")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {path or '/'} is a "
                        f"{type(tree).__name__}, not a tensor")
    return [(path, tree)]


def _rebuild(tree, by_path, path: str = ""):
    """``tree``'s structure (its own key order) with ``by_path[p]`` at the
    leaf of path ``p``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, by_path, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return by_path[path]


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _writes(flat) -> bool:
    """Whether this process writes a checkpoint of ``flat``: rank 0 alone
    when a leaf is a DTensor (each rank holds the same whole tree after
    the gather), else every process (its own tree)."""
    if not any(_is_dtensor(leaf) for _, leaf in flat):
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array to save, dtype name) of one leaf, a DTensor whole."""
    t = full(leaf).detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(path: str, step: int, tree, *, extra: Optional[Dict] = None,
                    keep: int = 3) -> str:
    flat = _flatten(tree)
    if not _writes(flat):
        for _, leaf in flat:
            full(leaf)                   # this rank's part of each gather
        return os.path.join(path, f"step_{step:08d}")
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    dtypes = []
    for i, (_, leaf) in enumerate(flat):
        arr, dtype = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        dtypes.append(dtype)
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "treedef": [p for p, _ in flat],
        "dtypes": dtypes,
        "time": time.time(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)           # atomic publish
    _gc(path, keep)
    return final


def _gc(path: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d[5:]) for d in os.listdir(path)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(path, d, "manifest.json"))]
    return max(steps) if steps else None


def _layouts(tree, path: str = ""):
    """path → leaf of a tree whose leaves may be anything (``Layout`` or
    None), in ``_flatten``'s order."""
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree)
                for p, v in _layouts(tree[k], f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, t in enumerate(tree)
                for p, v in _layouts(t, f"{path}/{i}").items()}
    return {path: tree}


@torch.no_grad()
def load_checkpoint(path: str, like_tree, *, step: Optional[int] = None,
                    shardings=None):
    """Restore into ``like_tree``: each leaf gets the checkpoint's values
    copied in (on its own device and in its own dtype).  With
    ``shardings`` (``Layout`` or None leaves mirroring ``like_tree``) a
    leaf gets this rank's piece of the saved whole array; a DTensor leaf
    gets the piece its own placements name.  Returns (like_tree's
    structure over those tensors, step, extra)."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = _flatten(like_tree)
    assert manifest["n_leaves"] == len(flat), \
        f"checkpoint has {manifest['n_leaves']} leaves, model has {len(flat)}"
    layouts = _layouts(shardings) if shardings is not None else {}
    for i, ((p, leaf), dtype) in enumerate(zip(flat, manifest["dtypes"])):
        arr = np.load(os.path.join(d, f"leaf_{i:05d}.npy"), mmap_mode="r")
        layout, dest = layouts.get(p), leaf
        if _is_dtensor(leaf):
            layout, dest = Layout.of(leaf), leaf.to_local()
        if layout is not None:
            arr = arr[tuple(slice(lo, hi)
                            for lo, hi in layout.bounds(arr.shape))]
        if tuple(arr.shape) != tuple(dest.shape):
            raise ValueError(f"{p}: checkpoint shape {arr.shape}, tree "
                             f"shape {tuple(dest.shape)}")
        dest.copy_(_tensor(np.array(arr), dtype))
    return _rebuild(like_tree, dict(flat)), step, manifest["extra"]


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of ``leaf`` that later in-place steps cannot change
    (``Tensor.cpu()`` of a CPU tensor is the tensor itself)."""
    return full(leaf).detach().to("cpu", copy=True)


class CheckpointManager:
    """Async save + retention.  ``save`` snapshots to host then writes on a
    background thread so the train loop is not blocked; ``latest`` and
    ``restore`` wait for that write (the reference's do not, so a failure
    within a save's write replays from the last good step on the current
    state: ROADMAP.md queue 3)."""

    def __init__(self, path: str, keep: int = 3, async_save: bool = True):
        self.path = path
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(path, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: Optional[Dict] = None):
        self.wait()
        flat = _flatten(tree)
        writes = _writes(flat)
        host_tree = _rebuild(tree, {p: _snapshot(leaf) for p, leaf in flat})
        if not writes:                    # another rank writes it
            return

        def work():
            try:
                save_checkpoint(self.path, step, host_tree, extra=extra,
                                keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def restore(self, like_tree, shardings=None):
        self.wait()
        return load_checkpoint(self.path, like_tree, shardings=shardings)

    @property
    def latest(self) -> Optional[int]:
        """The latest published step, a save still being written included
        (it waits for it): a restore right after an async save must find
        that checkpoint, not an older one or none."""
        self.wait()
        return latest_step(self.path)
