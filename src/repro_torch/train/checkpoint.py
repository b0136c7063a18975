"""Checkpointing (the reference's ``train/checkpoint.py`` format): atomic
writes, an asynchronous save thread, retention.

A tree (dicts and lists with tensors or arrays at the leaves) flattens to
one npz array per leaf under a path key (``params/stack/0/l0/attn/wq``),
written to a temp file and moved into place with ``os.replace`` (atomic on
POSIX), then ``MANIFEST.json`` with the latest step. An empty dict (a
non-parametric norm) is recorded by a ``~empty~`` marker, so restore is
lossless. bf16 tensors are stored as f32 (exact; numpy has no bf16).
Restore returns numpy arrays, or tensors on ``device``.

Elastic restore: checkpoints hold *whole* arrays (a run over a mesh
gathers its blocks before it saves); ``restore(shardings=...)`` keeps the
block of every leaf that the given spec tree names on the mesh installed
with ``use_rules`` (``launch/shardings.py``), whatever mesh wrote it: a
run restarted on (1, 4) reads a (2, 2) run's checkpoint unchanged.
"""
from __future__ import annotations

import json
import os
import pathlib
import queue
import threading
import time

import numpy as np
import torch


def _host(x) -> np.ndarray:
    """A host copy of a leaf that owns its memory: the train step updates
    params and AdamW moments in place, and a CPU tensor's ``.numpy()`` is
    a view of it, so an asynchronous save must not write from a view."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        elif x.device.type == "cpu":
            x = x.clone()
        return x.cpu().numpy()
    return np.array(x, copy=True)


def _flatten(tree, prefix: str = "", leaf: type | None = None) -> dict:
    """{path: leaf}; ``leaf`` a type whose instances are leaves even where
    they are tuples (a spec tree's PartitionSpecs)."""
    if isinstance(tree, (dict, list, tuple)) and not (
            leaf is not None and isinstance(tree, leaf)):
        items = (sorted(tree.items()) if isinstance(tree, dict)
                 else [(str(i), v) for i, v in enumerate(tree)])
        out = {}
        if not items:
            out[f"{prefix}~empty~"] = np.zeros(0, np.uint8)
        for k, v in items:
            out.update(_flatten(v, f"{prefix}{k}/", leaf))
        return out
    return {prefix.rstrip("/"): tree}


def _listify(node):
    """Dicts keyed 0..n-1 (flattened lists) back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node) and \
            sorted(map(int, node)) == list(range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def _unflatten(flat: dict):
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if parts[-1] != "~empty~":
            node[parts[-1]] = val
    return _listify(tree)


class CheckpointManager:
    """Directory of step-numbered checkpoints with retention + async saves."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._queue: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._errors: list[Exception] = []

    # ---------------- sync API ----------------
    def save(self, step: int, tree) -> pathlib.Path:
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        return self._write(step, host)

    def _write(self, step: int, host: dict) -> pathlib.Path:
        path = self.dir / f"ckpt_{step:08d}.npz"
        tmp = path.with_suffix(".tmp.npz")
        np.savez(tmp, **host)
        os.replace(tmp, path)  # atomic
        manifest = self.dir / "MANIFEST.json"
        mtmp = manifest.with_suffix(".tmp")
        mtmp.write_text(json.dumps({"latest_step": step,
                                    "time": time.time()}))
        os.replace(mtmp, manifest)
        self._gc()
        return path

    def _gc(self):
        ckpts = sorted(self.dir.glob("ckpt_*.npz"))
        for old in ckpts[:-self.keep]:
            old.unlink(missing_ok=True)

    # ---------------- async API ----------------
    def save_async(self, step: int, tree):
        """Copy to the host now; serialise and write on a worker thread."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._queue.put((step, host))

    def _drain(self):
        while True:
            try:
                step, host = self._queue.get(timeout=5.0)
            except queue.Empty:
                return
            try:
                self._write(step, host)
            except Exception as e:  # surfaced on wait()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def wait(self):
        """Block until every queued save is written; raise the first error."""
        self._queue.join()
        if self._errors:
            raise self._errors[0]

    # ---------------- restore ----------------
    def latest_step(self) -> int | None:
        manifest = self.dir / "MANIFEST.json"
        if not manifest.exists():
            ckpts = sorted(self.dir.glob("ckpt_*.npz"))
            if not ckpts:
                return None
            return int(ckpts[-1].stem.split("_")[1])
        return int(json.loads(manifest.read_text())["latest_step"])

    def restore(self, step: int | None = None, shardings=None, device=None):
        """(step, tree) of a checkpoint (default the latest): numpy arrays,
        or tensors on ``device``. ``shardings``: a spec tree of the tree's
        structure (or of a part of it: leaves it does not reach stay whole);
        each leaf is cut to this rank's block on the installed mesh."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = self.dir / f"ckpt_{step:08d}.npz"
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        if shardings is not None:
            flat = _local_blocks(flat, shardings)
        if device is not None:
            flat = {k: v if k.endswith("~empty~")
                    else torch.from_numpy(np.array(v)).to(device)
                    for k, v in flat.items()}
        return step, _unflatten(flat)


def _local_blocks(flat: dict, shardings) -> dict:
    """Each flattened leaf cut to this rank's block by its spec in
    ``shardings`` (by path; leaves without a spec stay whole)."""
    from ..launch.shardings import local_shard
    from ..parallel.logical import PartitionSpec, current_mesh
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("restore(shardings=...) cuts blocks on the mesh "
                         "installed with use_rules(rules, mesh); none is")
    specs = {k: v for k, v in _flatten(shardings, leaf=PartitionSpec).items()
             if isinstance(v, PartitionSpec)}
    return {k: np.ascontiguousarray(local_shard(v, specs[k], mesh))
            if k in specs else v for k, v in flat.items()}
