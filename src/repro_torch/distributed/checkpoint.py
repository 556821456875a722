"""Checkpointing: atomic, async, content-verified (port of
``repro.distributed.checkpoint``, one device).

Layout (one directory per step), the JAX package's byte for byte:
    <dir>/step_<n>.tmp/...   -> written, fsynced, manifest-hashed
    <dir>/step_<n>/          -> one atomic rename commits the checkpoint

Every leaf is a raw ``.npy`` (``leaf_{i:05d}.npy``) plus a JSON manifest
holding its key, shape, dtype and a crc32 of its bytes; restore verifies
each, so a partial write is never loaded.  A leaf's key joins the dict keys
(sorted), tuple indices and NamedTuple field names on its path with "/",
and ``None`` leaves are left out, as ``jax.tree_util`` flattens a tree; so
an artifact written by either package restores in the other.  A bf16 leaf
is written widened to f32 with ``"bfloat16"`` in the manifest and narrowed
on restore.  ``CheckpointStore.save_async`` copies every leaf to host
memory at once and serializes on a background thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# the torch type numpy cannot hold: written widened to f32, narrowed on restore
_WIDENED = {torch.bfloat16: "bfloat16"}
_NARROW = {name: dt for dt, name in _WIDENED.items()}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_paths(tree: Any, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in ``jax.tree_util.tree_flatten_with_path``
    order: dict keys sorted, tuples and NamedTuples in field order, ``None``
    dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    return [kv for k, v in items for kv in _flatten_with_paths(v, prefix + (k,))]


def _unflatten(like: Any, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),)) for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves, prefix + (f,))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves, prefix + (str(i),)) for i, v in enumerate(like))
    return leaves["/".join(prefix)]


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype) of one leaf."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype in _WIDENED:
            return t.float().numpy(), _WIDENED[t.dtype]
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "extra": extra or {},
                                "time": time.time()}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr, dtype = _host_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype,
                                   "crc32": zlib.crc32(arr.tobytes())}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and not name.endswith(".tmp")
             and os.path.exists(os.path.join(directory, name, "manifest.json"))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any, shardings: Any = None,
                       verify: bool = True, strict_shapes: bool = True) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like``: each leaf as a tensor in the
    manifest's dtype on the device of ``like``'s leaf (the CPU where that
    leaf is not a tensor).  ``strict_shapes=False`` returns each leaf at its
    saved shape.  ``shardings`` is the JAX signature's multi-device
    placement, which the one-device port does not take."""
    if shardings is not None:
        raise NotImplementedError("restore_checkpoint: shardings (multi-device placement) "
                                  "are not ported")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for key, leaf in _flatten_with_paths(like):
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(path, meta["file"]))
        if verify and zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"checksum mismatch for {key} — corrupt checkpoint")
        if strict_shapes and list(arr.shape) != list(np.shape(leaf)):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(np.shape(leaf))}")
        t = torch.from_numpy(arr)
        if meta["dtype"] in _NARROW:  # lossless narrow back (saved widened to f32)
            t = t.to(_NARROW[meta["dtype"]])
        elif str(arr.dtype) != meta["dtype"]:
            raise TypeError(f"leaf {key}: saved as {arr.dtype}, manifest says {meta['dtype']}")
        leaves[key] = t.to(leaf.device) if torch.is_tensor(leaf) else t
    return _unflatten(like, leaves), manifest["extra"]


def restore_latest(directory: str, like: Any, shardings: Any = None, verify: bool = True,
                   strict_shapes: bool = True) -> Optional[Tuple[int, Any, Dict]]:
    """Restore the newest committed checkpoint in ``directory`` (or None if
    the directory holds none)."""
    step = latest_step(directory)
    if step is None:
        return None
    tree, extra = restore_checkpoint(directory, step, like, shardings, verify, strict_shapes)
    return step, tree, extra


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(directory)
                   if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)


def _host_copy(leaf: Any) -> Any:
    """A host copy of one tensor leaf: a CUDA leaf into a pinned buffer by a
    non-blocking copy (the caller synchronizes), a CPU leaf cloned."""
    if not torch.is_tensor(leaf):
        return leaf
    if leaf.is_cuda:
        out = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        return out.copy_(leaf.detach(), non_blocking=True)
    return leaf.detach().clone()


def _to_host(tree: Any) -> Any:
    """A host copy of every tensor leaf, with one synchronize if any leaf
    is on the card (the caller may update its tensors in place while the
    copy is written)."""
    leaves = _flatten_with_paths(tree)
    out = _unflatten(tree, {k: _host_copy(v) for k, v in leaves})
    if any(torch.is_tensor(v) and v.is_cuda for _, v in leaves):
        torch.cuda.synchronize()
    return out


class CheckpointStore:
    """One root directory of atomic ``step_<n>`` artifacts with synchronous
    and background-thread writes, latest-committed reads, manifest-only
    metadata reads and the ``strict_shapes`` restore contract.  A reader
    only ever sees directories that finished the tmp-then-rename commit."""

    def __init__(self, root: str, keep: int = 0):
        self.root = root
        self.keep = keep                     # 0 = keep every step
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        """Synchronous atomic write; returns the committed path."""
        path = save_checkpoint(self.root, step, tree, extra)
        if self.keep:
            prune_checkpoints(self.root, self.keep)
        return path

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Host-copy now (one device sync), serialize on a background thread.
        Saves are ordered: a still-running previous save is joined first, and
        its error (if any) surfaces here or on the next ``wait()``."""
        self.wait()
        host_tree = _to_host(tree)

        def work():
            try:
                self.save(step, host_tree, extra)
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight background save (re-raising its error)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return latest_step(self.root)

    def read_extra(self, step: Optional[int] = None) -> Optional[Dict]:
        """Manifest-only read of a committed artifact's ``extra`` record."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with open(os.path.join(self.root, f"step_{step:08d}", "manifest.json")) as f:
            return json.load(f).get("extra", {})

    def restore(self, like: Any, step: Optional[int] = None, shardings: Any = None,
                verify: bool = True, strict_shapes: bool = True
                ) -> Optional[Tuple[int, Any, Dict]]:
        """(step, tree, extra) of ``step`` — default the latest committed —
        or None when the store holds no committed artifact."""
        if step is None:
            return restore_latest(self.root, like, shardings, verify, strict_shapes)
        tree, extra = restore_checkpoint(self.root, step, like, shardings, verify,
                                         strict_shapes)
        return step, tree, extra

    def prune(self, keep: Optional[int] = None) -> None:
        prune_checkpoints(self.root, keep if keep is not None else (self.keep or 3))


class AsyncCheckpointer:
    """The JAX package's older facade over :class:`CheckpointStore`:
    ``save`` is the asynchronous write."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.store = CheckpointStore(directory, keep=keep)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        self.store.save_async(step, tree, extra)

    def wait(self) -> None:
        self.store.wait()
