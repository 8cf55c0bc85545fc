"""Checkpoint and resume, counterpart of ``tpu_flash/utils/checkpoint.py``,
on the JAX package's on-disk layout, so that either package reads the
other's float32 checkpoints:

    <dir>/step_<N>/arrays.npz   one array a leaf, keyed by its '/'-joined path
    <dir>/step_<N>/meta.json    step, the tree's structure, each leaf's dtype,
                                the caller's metadata

A write goes to ``step_<N>.tmp`` and is renamed into place, so that a killed
process never leaves a half-written step that restore would take; the
newest ``keep`` steps are kept.  Trees are dicts, lists, tuples and
NamedTuples of tensors (or numpy arrays).  numpy has no bfloat16 (and the
card's machine no ``ml_dtypes``), so a bf16 leaf is stored as its uint16
bits with ``"bfloat16"`` as its dtype in ``meta.json``; restore turns those
bits (or a JAX file's two-byte bf16 values) back into a bf16 tensor.
Restored leaves are CPU tensors; NamedTuple nodes come back as
NamedTuples with the same field names.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from tpu_flash_torch.nn.optim import tree_map


def _flatten_with_paths(tree: Any, prefix: str = ""):
    """(path, leaf) pairs, '/'-joined dict keys (sorted) and indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}{i}/")
    elif tree is None:
        yield prefix[:-1] + "#none", None
    else:
        yield prefix[:-1], tree


def _treedef_spec(tree: Any) -> Any:
    """The JSON structure descriptor that restore rebuilds the tree from."""
    if isinstance(tree, dict):
        return {"__kind__": "dict",
                "items": {k: _treedef_spec(v) for k, v in tree.items()}}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"__kind__": "namedtuple", "name": type(tree).__name__,
                "fields": list(tree._fields),
                "items": [_treedef_spec(v) for v in tree]}
    if isinstance(tree, (list, tuple)):
        return {"__kind__": "list" if isinstance(tree, list) else "tuple",
                "items": [_treedef_spec(v) for v in tree]}
    if tree is None:
        return {"__kind__": "none"}
    return {"__kind__": "leaf"}


def _gather(tree: Any) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """A host copy of every leaf (the one point that waits for the card;
    a copy on the CPU too, since steps update parameters in place) and each
    leaf's dtype name."""
    arrays, dtypes = {}, {}
    for path, leaf in _flatten_with_paths(tree):
        if leaf is None:
            continue
        if torch.is_tensor(leaf):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                arrays[path] = t.view(torch.int16).numpy().view(np.uint16)
                dtypes[path] = "bfloat16"
                continue
            arrays[path] = t.numpy()
        else:
            arrays[path] = np.asarray(leaf)
        dtypes[path] = str(arrays[path].dtype)
    return arrays, dtypes


def _write(directory: str, step: int, arrays: dict, dtypes: dict,
           structure: Any, metadata: dict | None, keep: int) -> str:
    """Serialize and rename into place, then prune (host IO only)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "structure": structure, "dtypes": dtypes,
                   "metadata": metadata or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in list_checkpoints(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"))
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    metadata: dict | None = None, keep: int = 3) -> str:
    """Save ``tree`` as step ``step`` and keep the newest ``keep`` steps;
    returns the step's directory."""
    arrays, dtypes = _gather(tree)
    return _write(directory, step, arrays, dtypes, _treedef_spec(tree),
                  metadata, keep)


class AsyncCheckpointer:
    """Saves that overlap training: ``save()`` copies the tree to the host
    at once (later steps update the parameters in place), then a single
    worker thread writes it.  One write is in flight at a time, so steps
    land in order; ``wait()`` and ``close()`` re-raise a write's error."""

    def __init__(self, keep: int = 3):
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
        self._pending = None

    def save(self, directory: str, step: int, tree: Any,
             metadata: dict | None = None) -> None:
        arrays, dtypes = _gather(tree)
        structure = _treedef_spec(tree)
        self.wait()
        self._pending = self._pool.submit(
            _write, directory, step, arrays, dtypes, structure, metadata,
            self.keep)

    def wait(self) -> str | None:
        """Block until the write in flight (if any) is done; returns its
        path and re-raises its error."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def _leaf(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr, order="C")       # keeps a 0-d leaf 0-d
    if dtype == "bfloat16":              # two-byte values, as bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(spec: Any, arrays: dict, dtypes: dict, prefix: str = ""):
    kind = spec["__kind__"]
    if kind == "dict":
        return {k: _rebuild(v, arrays, dtypes, f"{prefix}{k}/")
                for k, v in spec["items"].items()}
    if kind in ("list", "tuple", "namedtuple"):
        items = [_rebuild(v, arrays, dtypes, f"{prefix}{i}/")
                 for i, v in enumerate(spec["items"])]
        if kind == "list":
            return items
        if kind == "namedtuple":
            return collections.namedtuple(spec["name"], spec["fields"])(
                *items)
        return tuple(items)
    if kind == "none":
        return None
    key = prefix[:-1]
    return _leaf(arrays[key], dtypes.get(key, ""))


def restore_checkpoint(directory: str, step: int | None = None):
    """``(tree, step, metadata)`` of the given step, or of the newest."""
    steps = list_checkpoints(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    if step is None:
        step = steps[-1]
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}
    tree = _rebuild(meta["structure"], arrays, meta["dtypes"])
    return tree, meta["step"], meta["metadata"]


def restore_like(template: Any, tree: Any) -> Any:
    """``tree``'s leaves in ``template``'s structure (its NamedTuple
    classes), each on its template leaf's device and in its dtype: the
    live optimizer state rebuilt from a restored one."""
    def like(t, r):
        r = torch.as_tensor(r)
        if r.shape != t.shape:
            raise ValueError(f"restored shape {tuple(r.shape)} does not "
                             f"match {tuple(t.shape)}")
        return r.to(device=t.device, dtype=t.dtype)

    return tree_map(like, template, tree)
