"""Checkpoints: port of ``repro/checkpoint/manager.py`` (``save``,
``restore``, ``CheckpointManager``, and the restore onto another mesh) on
the standard library and torch.

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

Sharded (:func:`save_sharded`, a trainer across ranks): each rank writes
the blocks it holds, each block once (a block held by several ranks is
written by the one at coordinate 0 of the mesh dims that do not split its
leaf), as ``rank_<r>.bin`` + ``rank_<r>.json`` (the blocks' leaf paths,
starts, shapes, byte offsets); rank 0 then writes ``manifest.json``
(format ``SHARDED_FORMAT``: every leaf's whole shape and dtype, and every
rank's blocks) and renames the directory into place.  Nothing goes
through one rank.  ``restore(..., placements=, mesh=)`` reads either
format onto any mesh: each of this rank's new blocks is assembled from the
parts of the blocks on disk that it overlaps (an unsharded checkpoint is
one block a leaf).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import block_shape, block_start
from repro_torch.sharding.collectives import barrier

FORMAT = "repro_torch.checkpoint/1"
SHARDED_FORMAT = "repro_torch.checkpoint/sharded-1"


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


def _writes_block(placement, mesh) -> bool:
    """Whether this rank writes its block of a leaf: it sits at coordinate
    0 of every mesh dim that does not split the leaf."""
    split = set(placement.split_axes)
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names
               if a not in split)


def save_sharded(path: str, tree: Any, placements: Any, mesh, *,
                 extra: Optional[dict] = None) -> str:
    """Write ``tree``'s blocks (this rank's, laid out by ``placements``, a
    tree of ``tree``'s structure, on ``mesh``) to ``path``: a collective
    call, every rank of the mesh makes it.  Atomic: the blocks go into a
    temporary directory that rank 0 renames into place when every rank has
    written."""
    rank = dist.get_rank()
    parent = os.path.dirname(path) or "."
    tmp = os.path.join(parent, ".ckpt_tmp_" + os.path.basename(path))
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    barrier(mesh)
    leaves = _flatten(tree)
    pls = [pl for _, pl in _flatten(placements)]
    blocks = []
    offset = 0
    with open(os.path.join(tmp, f"rank_{rank}.bin"), "wb") as f:
        for (key, leaf), pl in zip(leaves, pls):
            if not _writes_block(pl, mesh):
                continue
            raw = _leaf_bytes(leaf)
            f.write(raw)
            blocks.append({"path": key, "start": list(block_start(pl, mesh)),
                           "shape": list(leaf.shape), "offset": offset,
                           "nbytes": raw.nbytes})
            offset += raw.nbytes
    with open(os.path.join(tmp, f"rank_{rank}.json"), "w") as f:
        f.write(json.dumps(blocks))
    barrier(mesh)
    if rank == 0:
        files = sorted(n for n in os.listdir(tmp) if n.endswith(".json"))
        if len(files) != mesh.size():
            raise RuntimeError(f"save_sharded: {len(files)} of "
                               f"{mesh.size()} ranks wrote their blocks")
        manifest = {"format": SHARDED_FORMAT, "n_leaves": len(leaves),
                    "extra": extra or {},
                    "leaves": [{"path": key,
                                "dtype": str(leaf.dtype).split(".")[-1],
                                "shape": list(pl.shape)}
                               for (key, leaf), pl in zip(leaves, pls)],
                    "ranks": [n[:-len(".json")] for n in files]}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(json.dumps(manifest))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)       # atomic publish
    barrier(mesh)
    return path


def _blocks_on_disk(path: str, manifest: dict) -> dict:
    """{leaf path: [(file, offset, nbytes, start, shape)]} of a checkpoint
    of either format."""
    out: dict = {}
    if manifest["format"] == FORMAT:
        data = os.path.join(path, "data.bin")
        for m in manifest["leaves"]:
            out[m["path"]] = [(data, m["offset"], m["nbytes"],
                               [0] * len(m["shape"]), m["shape"])]
        return out
    for name in manifest["ranks"]:
        with open(os.path.join(path, name + ".json")) as f:
            for b in json.load(f):
                out.setdefault(b["path"], []).append(
                    (os.path.join(path, name + ".bin"), b["offset"],
                     b["nbytes"], b["start"], b["shape"]))
    return out


def _read_region(blocks, dtype: torch.dtype, start, shape) -> torch.Tensor:
    """The region [start, start + shape) of a leaf, assembled from the
    blocks on disk that overlap it (host tensor)."""
    out = torch.empty(shape, dtype=dtype)
    covered = 0
    for fname, offset, nbytes, b_start, b_shape in blocks:
        lo = [max(a, b) for a, b in zip(start, b_start)]
        hi = [min(a + n, b + m) for a, n, b, m in
              zip(start, shape, b_start, b_shape)]
        if any(h <= l for l, h in zip(lo, hi)):
            continue
        if nbytes:
            raw = np.memmap(fname, dtype=np.uint8, mode="c", offset=offset,
                            shape=(nbytes,))
            block = torch.from_numpy(raw).view(dtype).reshape(b_shape)
        else:
            block = torch.empty(b_shape, dtype=dtype)
        src = block[tuple(slice(l - b, h - b)
                          for l, h, b in zip(lo, hi, b_start))]
        out[tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, start))] \
            = src
        covered += src.numel()
    if covered != out.numel():
        raise ValueError(f"checkpoint blocks cover {covered} of the "
                         f"{out.numel()} elements asked for")
    return out


def restore(path: str, target: Any, *, device=None, placements=None,
            mesh=None):
    """-> (tree shaped as ``target``, the saved ``extra``).  Each leaf in
    its target leaf's dtype, on ``device`` (None: the target leaf's
    device).  With ``placements`` (a tree of the target's structure) and
    ``mesh``, each leaf is this rank's block under its placement."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") not in (FORMAT, SHARDED_FORMAT):
        raise ValueError(f"checkpoint {path}: format "
                         f"{manifest.get('format')!r}, not {FORMAT!r} or "
                         f"{SHARDED_FORMAT!r}")
    targets = _flatten(target)
    metas = manifest["leaves"]
    if len(targets) != len(metas):
        raise ValueError(f"checkpoint {path}: {len(metas)} leaves, target "
                         f"has {len(targets)}")
    pls = ([None] * len(targets) if placements is None
           else [pl for _, pl in _flatten(placements)])
    on_disk = _blocks_on_disk(path, manifest)
    out = []
    for (key, ref), meta, pl in zip(targets, metas, pls):
        if key != meta["path"]:
            raise ValueError(f"checkpoint {path}: leaf {meta['path']} "
                             f"where the target has {key}")
        if pl is None:
            start, shape = [0] * len(meta["shape"]), meta["shape"]
        else:
            if list(pl.shape) != meta["shape"]:
                raise ValueError(f"checkpoint {path}: leaf {key} of shape "
                                 f"{meta['shape']}, placement {pl.shape}")
            start, shape = block_start(pl, mesh), block_shape(pl, mesh)
        t = _read_region(on_disk[key], getattr(torch, meta["dtype"]),
                         list(start), list(shape))
        out.append(t.to(device=device if device is not None else ref.device,
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

    def save(self, step: int, tree, extra=None, *, placements=None,
             mesh=None) -> str:
        """Write step ``step``; with ``placements`` and ``mesh`` each rank
        writes its blocks (:func:`save_sharded`, a collective call)."""
        path = os.path.join(self.dir, f"step_{step}")
        extra = dict(extra or {}, step=step)
        if mesh is None:
            save(path, tree, extra=extra)
        else:
            save_sharded(path, tree, placements, mesh, extra=extra)
        if mesh is None or mesh.get_coordinate() == [0] * mesh.ndim:
            for _, d in self._step_dirs()[:-self.keep]:
                shutil.rmtree(d, ignore_errors=True)
        return path

    def restore_latest(self, target, device=None, *, placements=None,
                       mesh=None):
        """-> (tree, extra) of the newest checkpoint, or (None, None); with
        ``placements`` and ``mesh``, this rank's blocks."""
        step = self.latest_step()
        if step is None:
            return None, None
        return restore(os.path.join(self.dir, f"step_{step}"), target,
                       device=device, placements=placements, mesh=mesh)
