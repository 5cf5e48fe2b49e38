"""Atomic, sharded, resumable checkpoints in the reference's on-disk format.

Port of ``repro/ckpt/checkpoint.py``.  The layout is the reference's, so a
checkpoint written by either package restores in the other::

    <root>/step_000123/
        manifest.json      # step, extra, leaves (key, name, shard, shape, dtype), n_shards
        shard_00000.npz    # flat leaves (split into ~512 MB shards)
    <root>/LATEST          # atomic pointer file

A tree is nested dicts of tensors, numpy arrays or scalars.
Its leaves are stored in JAX's flatten order (dict keys sorted at every
level), each under its path joined with ``/`` (``opt/m/embed``,
``opt/step``, ``params/segments/dense/p0/attn/wq``).

bf16: numpy has no bfloat16 of its own (the reference gets one from
``ml_dtypes``, which the port does not use).  The port stores a bf16 leaf as
2-byte integers with manifest dtype ``"bfloat16"``; the reference's
``_restore_dtype`` views those back.  The reference's own bf16 leaves come
back from ``np.load`` as raw 2-byte voids; the port views either kind as
``torch.bfloat16`` bit for bit.

Guarantees (the reference's): atomic ``step_X.tmp-<pid>`` then
``os.rename``, ``LATEST`` through ``os.replace``, keep-k GC after a save,
one async save in flight (the tree is copied to the host before ``save``
returns, then written by a thread; ``wait()`` joins it and raises its
error).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager"]

BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flatten order: dict keys sorted."""
    if not isinstance(tree, Mapping):
        return [("/".join(prefix), tree)]
    out = []
    for k in sorted(tree):
        out += _flatten_with_paths(tree[k], prefix + (str(k),))
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as numpy, and its manifest dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _restore_leaf(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A stored leaf as a tensor of its manifest dtype: bf16 from the
    reference's raw voids or the port's int16, bit for bit."""
    if dtype_str == BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    if str(arr.dtype) != dtype_str:
        raise ValueError(f"a {dtype_str} leaf stored as {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, shard_bytes: int = 512 * 2**20):
        self.root = root
        self.keep = keep
        self.shard_bytes = shard_bytes
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            s = int(f.read().strip())
        return s if os.path.isdir(self._step_dir(s)) else None

    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, extra: Optional[Dict] = None, blocking: bool = True):
        """Snapshot ``tree`` (device -> host) and persist it."""
        self.wait()  # one in-flight save at a time
        host = [(k, *_to_host(v)) for k, v in _flatten_with_paths(tree)]

        def _write():
            try:
                self._write_ckpt(step, host, extra or {})
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e

    def _write_ckpt(self, step: int, host: List[Tuple[str, np.ndarray, str]], extra: Dict):
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        # pack leaves into size-bounded npz shards
        manifest: Dict[str, Any] = {"step": step, "extra": extra, "leaves": [], "n_shards": 0}
        shard: Dict[str, np.ndarray] = {}
        shard_size = 0
        shard_id = 0

        def flush():
            nonlocal shard, shard_size, shard_id
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_id:05d}.npz"), **shard)
                shard_id += 1
                shard, shard_size = {}, 0

        for i, (key, arr, dtype_str) in enumerate(host):
            name = f"leaf_{i:06d}"
            manifest["leaves"].append(
                {"key": key, "name": name, "shard": shard_id,
                 "shape": list(arr.shape), "dtype": dtype_str}
            )
            shard[name] = arr
            shard_size += arr.nbytes
            if shard_size >= self.shard_bytes:
                flush()
        flush()
        manifest["n_shards"] = shard_id
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # atomic LATEST pointer
        lp = os.path.join(self.root, "LATEST")
        with open(lp + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(lp + ".tmp", lp)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------ #
    def restore(self, step: int, like=None):
        """Load the checkpoint at ``step`` as CPU tensors.

        Without ``like``, returns a flat ``{key: tensor}`` dict.  With
        ``like`` (a tree of tensors, ``meta`` ones included, or of anything
        with a ``shape``), returns a tree of its structure whose leaves are
        matched to the stored ones by key; a leaf of ``like`` that is not
        stored, or is stored with another shape (or, for a tensor, another
        dtype), raises.
        """
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        shards = {}
        for rec in manifest["leaves"]:
            sid = rec["shard"]
            if sid not in shards:
                shards[sid] = np.load(os.path.join(d, f"shard_{sid:05d}.npz"))
        flat = {r["key"]: _restore_leaf(shards[r["shard"]][r["name"]], r["dtype"])
                for r in manifest["leaves"]}
        if like is None:
            return flat, manifest
        return _unflatten_like(like, flat, ()), manifest


def _unflatten_like(like, flat: Dict[str, torch.Tensor], prefix: Tuple[str, ...]):
    """``like``'s structure with each leaf taken from ``flat`` by its key."""
    if isinstance(like, Mapping):
        return {k: _unflatten_like(v, flat, prefix + (str(k),)) for k, v in like.items()}
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    leaf = flat[key]
    if tuple(leaf.shape) != tuple(np.shape(like)):
        raise ValueError(f"{key}: stored shape {tuple(leaf.shape)}, expected "
                         f"{tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor) and leaf.dtype != like.dtype:
        raise ValueError(f"{key}: stored dtype {leaf.dtype}, expected {like.dtype}")
    return leaf
