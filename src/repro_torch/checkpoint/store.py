"""Fault-tolerant checkpointing.

Port of ``repro.checkpoint.store``, with its contract:

* **atomic**: a checkpoint is a directory written under a temporary name
  and renamed into place, its manifest written last, so a crash mid-write
  never leaves a checkpoint that :meth:`CheckpointStore.latest_step` would
  pick up;
* **async**: :meth:`CheckpointStore.save_async` copies the tensors to host
  memory at once (copies, so the train loop may go on and replace them) and
  writes the file on a background thread; :meth:`CheckpointStore.wait`
  joins it before the next save or on exit;
* **self-validating**: the manifest holds the payload's sha256, and
  ``latest_step`` skips corrupt and partial checkpoints;
* ``keep`` newest checkpoints are kept.

The payload is one ``arrays.npz`` whose keys are the tree's paths joined by
"/" (dict keys in sorted order), exactly as the reference's ``_flatten``
makes them, so a checkpoint moves between the packages.  numpy has no
bfloat16: a bf16 tensor is stored as its raw 2-byte words (``|V2``, what
``np.savez`` makes of the reference's ml_dtypes bfloat16 arrays) and the
manifest records ``"dtypes": {key: "bfloat16"}``; :meth:`restore` takes the
bits back as they were.  ``restore(step, like_tree, device=...)`` puts each
leaf on ``device`` in the like leaf's dtype; ``device=None`` means the card,
as everywhere in the port.

**On a mesh** (the reference's elastic restore): ``save(..., mesh=,
specs=)`` takes each rank's blocks and puts every leaf together on the host
of global rank 0, which writes the same file and manifest as one card
would.  The leaves are gathered one at a time, and a stacked leaf one slice
of its first unsplit dim (one layer) at a time, each slice copied to the
host and freed before the next is gathered (a collective: every rank calls
it), so no card holds more than one such slice beyond its own blocks.
``restore(..., mesh=, specs=)`` reads the whole leaves one at a time and
keeps this rank's block of each, for whatever mesh it is given, so a run
saved on one mesh resumes on another, or on one device, bit for bit.
:meth:`CheckpointStore.wait` ends with a barrier over the process group
once a save on a mesh was made, so no rank reads a checkpoint before it
is written.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.collectives import whole
from ..parallel.spec import axis_size, local_shard

_BF16_WORD = np.dtype("V2")


def _paths(tree, prefix=()):
    """(path, leaf) pairs of nested dicts, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _host_array(leaf) -> np.ndarray:
    """A numpy copy of a tensor (bf16 as its raw words), array or number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORD)
        return t.numpy()
    return np.array(leaf, copy=True)


def _whole_on_host(t: torch.Tensor, mesh, spec, keep: bool):
    """The whole leaf of which ``t`` is this rank's block by ``spec``, as a
    host array where ``keep`` (None elsewhere).  It is gathered one slice
    along its first dim that no axis splits at a time (a stacked leaf's
    layers), each slice freed on the card once copied to the host."""
    entries = tuple(spec) + (None,) * (t.dim() - len(spec))
    if all(axis_size(mesh, e) == 1 for e in entries):
        return _host_array(t) if keep else None
    free = next((d for d, e in enumerate(entries) if e is None and t.shape[d] > 1), None)
    if free is None:
        piece = whole(t, mesh, spec)  # a collective: on every rank
        return _host_array(piece) if keep else None
    out = None
    for i in range(t.shape[free]):
        piece = whole(t.narrow(free, i, 1), mesh, spec)
        if keep:
            host = _host_array(piece)
            if out is None:
                shape = list(host.shape)
                shape[free] = t.shape[free]
                out = np.empty(shape, host.dtype)
            out[(slice(None),) * free + (slice(i, i + 1),)] = host
        del piece
    return out


def _flatten(tree):
    """(flat arrays keyed by path, {key: "bfloat16"} for the bf16 leaves)."""
    flat, dtypes = {}, {}
    for key, leaf in _paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
        flat[key] = _host_array(leaf)
    return flat, dtypes


def _to_tensor(arr: np.ndarray, like, device) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on ``device``; 2-byte words
    (bf16 stored raw) are taken bit for bit."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape}, expected {tuple(like.shape)}")
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 and arr.dtype.kind in "Viu":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(device)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh_saved = False

    # -- discovery -----------------------------------------------------------
    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and self._valid(os.path.join(self.dir, name)):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _valid(self, path: str) -> bool:
        mpath = os.path.join(path, "manifest.json")
        if not os.path.exists(mpath):
            return False
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            for fname, digest in manifest["checksums"].items():
                fpath = os.path.join(path, fname)
                if not os.path.exists(fpath) or _sha256(fpath) != digest:
                    return False
            return True
        except (json.JSONDecodeError, KeyError, OSError):
            return False

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None, *, mesh=None,
             specs=None):
        self.wait()
        flat, dtypes = self._snapshot(tree, mesh, specs)  # the device-to-host copy
        if flat is not None:
            self._write(step, flat, dtypes, extra or {})
        self.wait()

    def save_async(self, step: int, tree, extra: Optional[Dict[str, Any]] = None, *,
                   mesh=None, specs=None):
        self.wait()
        flat, dtypes = self._snapshot(tree, mesh, specs)  # a host snapshot now
        if flat is not None:  # the file in the background
            self._thread = threading.Thread(target=self._write_caught,
                                            args=(step, flat, dtypes, extra or {}), daemon=True)
            self._thread.start()

    def _snapshot(self, tree, mesh, specs):
        """(flat host arrays, bf16 keys) of the tree, whole leaves on a mesh;
        (None, None) on the ranks of a mesh that do not write."""
        if mesh is None:
            return _flatten(tree)
        import torch.distributed as dist

        self._mesh_saved = True
        keep = dist.get_rank() == 0
        flat, dtypes = {}, {}
        for key, leaf in _paths(tree):
            host = _whole_on_host(leaf, mesh, _at(specs, key), keep)
            if keep:
                flat[key] = host
                if leaf.dtype == torch.bfloat16:
                    dtypes[key] = "bfloat16"
        return (flat, dtypes) if keep else (None, None)

    def wait(self):
        """Join the background write; re-raises what it raised.  After a
        save on a mesh, every rank waits here for the writer."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh_saved:
            import torch.distributed as dist

            self._mesh_saved = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_caught(self, *args):
        try:
            self._write(*args)
        except BaseException as e:  # handed to the next wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
               extra: Dict):
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=self.dir)
        try:
            payload = os.path.join(tmp, "arrays.npz")
            np.savez(payload, **flat)
            manifest = {"step": step, "extra": extra, "dtypes": dtypes,
                        "checksums": {"arrays.npz": _sha256(payload)}}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def restore(self, step: int, like_tree, device=None, *, mesh=None, specs=None):
        """The checkpoint of ``step`` in the structure of ``like_tree``,
        whose leaves (tensors, on any device, "meta" too) give each leaf's
        whole shape and dtype; every leaf lands on ``device``.  With a mesh,
        each leaf is this rank's block of it by ``specs``."""
        device = resolve_device(device, "CheckpointStore.restore")
        path = os.path.join(self.dir, f"step_{step:010d}")

        def leaf(data, key, like):
            t = _to_tensor(data[key], like, "cpu")
            if mesh is not None:
                t = local_shard(t, _at(specs, key), mesh)
            return t.to(device)

        # one leaf in host memory at a time: every rank of a mesh reads the
        # whole file and keeps its blocks
        with np.load(os.path.join(path, "arrays.npz")) as data:
            return _unflatten(like_tree, lambda key, like: leaf(data, key, like))

    def extra(self, step: int) -> Dict:
        path = os.path.join(self.dir, f"step_{step:010d}", "manifest.json")
        with open(path) as f:
            return json.load(f)["extra"]


def _unflatten(tree, leaf_fn, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaf_fn, prefix + (str(k),)) for k in sorted(tree)}
    return leaf_fn("/".join(prefix), tree)


def _at(tree, key: str):
    """The leaf of nested dicts at a "/"-joined path."""
    for k in key.split("/"):
        tree = tree[k]
    return tree


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()
