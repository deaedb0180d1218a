"""Synthetic video stream generator — the port's own copy of
``repro/data/video.py`` (numpy, as the reference; nothing of it is
imported).

Streams are moving-blob scenes with a controllable *motion level* per
segment; the motion level doubles as the ground-truth content difficulty z
(what UA-DETRAC-style traffic scenes vary).  Used by the gate curriculum,
the serving simulator, and the paper-table benchmarks.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    height: int = 64
    width: int = 64
    n_blobs: int = 4
    frames_per_segment: int = 8
    seed: int = 0


def generate_stream(cfg: VideoConfig, n_segments: int, motion_profile=None, rng=None):
    """Returns (frames (T, H, W) float32 in [0,1], difficulty (n_segments,)).

    motion_profile: optional (n_segments,) array in [0,1]; default is a
    smooth random walk (scene dynamics drift over time, paper §2).
    """
    rng = rng or np.random.default_rng(cfg.seed)
    n_frames = n_segments * cfg.frames_per_segment + 1
    if motion_profile is None:
        steps = rng.normal(0, 0.15, n_segments)
        motion_profile = np.clip(0.5 + np.cumsum(steps), 0.05, 1.0)
    motion_profile = np.asarray(motion_profile)

    pos = rng.uniform(8, cfg.height - 8, (cfg.n_blobs, 2))
    vel = rng.normal(0, 1.0, (cfg.n_blobs, 2))
    size = rng.uniform(3, 7, cfg.n_blobs)
    yy, xx = np.mgrid[0 : cfg.height, 0 : cfg.width]

    frames = np.zeros((n_frames, cfg.height, cfg.width), np.float32)
    for t in range(n_frames):
        seg = min(t // cfg.frames_per_segment, n_segments - 1)
        speed = 0.3 + 4.0 * motion_profile[seg]
        pos = pos + vel * speed
        # bounce
        for d, lim in ((0, cfg.height), (1, cfg.width)):
            hit = (pos[:, d] < 2) | (pos[:, d] > lim - 2)
            vel[hit, d] *= -1
            pos[:, d] = np.clip(pos[:, d], 2, lim - 2)
        img = np.zeros((cfg.height, cfg.width), np.float32)
        for b in range(cfg.n_blobs):
            img += np.exp(
                -((yy - pos[b, 0]) ** 2 + (xx - pos[b, 1]) ** 2) / (2 * size[b] ** 2)
            )
        noise = rng.normal(0, 0.02, img.shape).astype(np.float32)
        frames[t] = np.clip(img / max(cfg.n_blobs / 2, 1) + noise, 0, 1)
    return frames, motion_profile


def make_task_batch(n_tasks: int, requirement: str = "stable", seed: int = 0):
    """Accuracy requirements per paper §4.1.2: stable U[0.6,0.7],
    fluctuating U[0.5,0.8]."""
    rng = np.random.default_rng(seed)
    if requirement == "stable":
        return rng.uniform(0.6, 0.7, n_tasks).astype(np.float32)
    return rng.uniform(0.5, 0.8, n_tasks).astype(np.float32)
