"""Checkpoints: port of ``repro/checkpoint/manager.py`` (``save``,
``restore``, ``CheckpointManager``) on the standard library and torch.

Layout:  <dir>/step_<n>/manifest.json  (leaf paths, dtypes, shapes, byte
                                         offsets; the caller's ``extra``)
         <dir>/step_<n>/data.bin       (the leaves' raw bytes, concatenated)

The reference writes a msgpack manifest and a zstd payload; neither
package is a dependency of the port, so the manifest is JSON and the
payload uncompressed.  Leaves go in the reference's flatten order (dict
keys sorted, lists in order) and each keeps its dtype (bfloat16 as its raw
2-byte words).  A save writes into a temporary directory beside the
target and renames it into place, so a failed save leaves the previous
checkpoint whole.  ``restore`` takes the tree structure and each leaf's
dtype from a target tree and puts the leaves on ``device`` (default: each
target leaf's own device).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import torch

FORMAT = "repro_torch.checkpoint/1"


def _flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in the reference's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in
                _flatten(t, f"{prefix}/{i}")]
    return [(prefix or "/", tree)]


def _unflatten(target, leaves):
    """``target``'s structure (its own key order) with the leaves of
    ``leaves`` (an iterator in :func:`_flatten`'s order)."""
    if isinstance(target, dict):
        out = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if isinstance(target, (list, tuple)):
        return [_unflatten(t, leaves) for t in target]
    return next(leaves)


def _leaf_bytes(t: torch.Tensor) -> memoryview:
    """A leaf's raw bytes (host copy, row-major)."""
    flat = t.detach().contiguous().cpu().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


def save(path: str, tree: Any, *, extra: Optional[dict] = None) -> str:
    """Write ``tree``'s tensor leaves to ``path`` atomically."""
    leaves = _flatten(tree)
    manifest = {"format": FORMAT, "n_leaves": len(leaves),
                "extra": extra or {}, "leaves": []}
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        offset = 0
        with open(os.path.join(tmp, "data.bin"), "wb") as f:
            for key, leaf in leaves:
                raw = _leaf_bytes(leaf)
                f.write(raw)
                manifest["leaves"].append({
                    "path": key, "dtype": str(leaf.dtype).split(".")[-1],
                    "shape": list(leaf.shape), "offset": offset,
                    "nbytes": raw.nbytes})
                offset += raw.nbytes
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(json.dumps(manifest))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)       # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def restore(path: str, target: Any, *, device=None):
    """-> (tree shaped as ``target``, the saved ``extra``).  Each leaf in
    its target leaf's dtype, on ``device`` (None: the target leaf's
    device)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"checkpoint {path}: format "
                         f"{manifest.get('format')!r}, not {FORMAT!r}")
    targets = _flatten(target)
    metas = manifest["leaves"]
    if len(targets) != len(metas):
        raise ValueError(f"checkpoint {path}: {len(metas)} leaves, target "
                         f"has {len(targets)}")
    out = []
    with open(os.path.join(path, "data.bin"), "rb") as f:
        for (key, ref), meta in zip(targets, metas):
            if key != meta["path"]:
                raise ValueError(f"checkpoint {path}: leaf {meta['path']} "
                                 f"where the target has {key}")
            dtype = getattr(torch, meta["dtype"])
            f.seek(meta["offset"])
            raw = bytearray(f.read(meta["nbytes"]))
            t = (torch.frombuffer(raw, dtype=torch.uint8).view(dtype)
                 if raw else torch.empty(0, dtype=dtype))
            out.append(t.reshape(meta["shape"]).to(
                device=device if device is not None else ref.device,
                dtype=ref.dtype))
    return _unflatten(target, iter(out)), manifest["extra"]


class CheckpointManager:
    """Retention and resume over ``save``/``restore``: ``step_<n>``
    directories under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dirs(self) -> list:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_"):
                try:
                    out.append((int(d.split("_")[1]),
                                os.path.join(self.dir, d)))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        ds = self._step_dirs()
        return ds[-1][0] if ds else None

    def save(self, step: int, tree, extra=None) -> str:
        path = os.path.join(self.dir, f"step_{step}")
        save(path, tree, extra=dict(extra or {}, step=step))
        for _, d in self._step_dirs()[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)
        return path

    def restore_latest(self, target, device=None):
        """-> (tree, extra) of the newest checkpoint, or (None, None)."""
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(os.path.join(self.dir, f"step_{step}"), target,
                       device=device)
