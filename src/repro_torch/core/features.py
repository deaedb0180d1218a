"""Motion features Δx_t = φ(I_t, I_{t-1}) (paper §3.2) — port of
``repro/core/features.py``.

φ combines the pixel-wise absolute difference and a histogram of its
magnitude, with 4x spatial downsampling and a causal temporal moving
average of window 3.  Output: Δx_t ∈ R^d per frame, d = 35.  Plain torch
ops on the frames' device (no kernel stands behind them), batched over
any leading axes (streams) where the reference vmaps over frames.
"""
from __future__ import annotations

import torch

DOWNSAMPLE = 4
MA_WINDOW = 3
HIST_BINS = 16
GRID = 4  # spatial pooling grid for the diff map


def feature_dim() -> int:
    """Width d of Δx_t: grid means + histogram + (mean, std, max) = 35."""
    return GRID * GRID + HIST_BINS + 3


def _downsample(x, factor: int):
    h, w = x.shape[-2], x.shape[-1]
    h2, w2 = h // factor, w // factor
    x = x[..., : h2 * factor, : w2 * factor]
    x = x.reshape(*x.shape[:-2], h2, factor, w2, factor)
    return x.mean(dim=(-3, -1))


def _soft_histogram(x, bins: int):
    """Differentiable histogram of each map's values in [0, 1]: (..., H,
    W) -> (..., bins)."""
    centers = (torch.arange(bins, dtype=x.dtype, device=x.device) + 0.5) \
        / bins
    width = 1.0 / bins
    w = torch.relu(1.0 - torch.abs(x[..., None] - centers) / width)
    return w.reshape(*x.shape[:-2], -1, bins).mean(dim=-2)


def _grid_pool(x, grid: int):
    h, w = x.shape[-2], x.shape[-1]
    gh, gw = max(h // grid, 1), max(w // grid, 1)
    x = x[..., : gh * grid, : gw * grid]
    x = x.reshape(*x.shape[:-2], grid, gh, grid, gw)
    return x.mean(dim=(-3, -1)).reshape(*x.shape[:-4], -1)


def frame_diff_features(prev_frame, frame):
    """φ of frame pairs before temporal smoothing: (..., H, W) in [0, 1]
    -> (..., d).  The std is the population one (``jnp.std``)."""
    diff = _downsample(torch.abs(frame - prev_frame), DOWNSAMPLE)
    grid = _grid_pool(diff, GRID)
    hist = _soft_histogram(torch.clamp(diff, 0.0, 1.0), HIST_BINS)
    flat = diff.reshape(*diff.shape[:-2], -1)
    stats = torch.stack([flat.mean(dim=-1), flat.std(dim=-1, correction=0),
                         flat.amax(dim=-1)], dim=-1)
    return torch.cat([grid, hist, stats], dim=-1)


def _moving_average(feats):
    """Causal moving average of window 3 over axis -2, the first row
    repeated before the start."""
    n = feats.shape[-2]
    first = feats[..., :1, :].expand(*feats.shape[:-2], MA_WINDOW - 1,
                                     feats.shape[-1])
    pad = torch.cat([first, feats], dim=-2)
    stacked = torch.stack([pad[..., i: i + n, :] for i in range(MA_WINDOW)],
                          dim=0)
    return stacked.mean(dim=0)


def motion_features(frames):
    """frames: (..., T, H, W) grayscale in [0, 1] -> Δx: (..., T-1, d),
    smoothed by the moving average of window 3."""
    return _moving_average(frame_diff_features(frames[..., :-1, :, :],
                                               frames[..., 1:, :, :]))


def segment_features(frames, segment_len: int):
    """Split each stream into segments of ``segment_len`` frames and
    mean-pool φ over a segment: (..., T, H, W) -> (..., (T-1) //
    segment_len, d)."""
    dx = motion_features(frames)
    n = dx.shape[-2] // segment_len
    dx = dx[..., : n * segment_len, :]
    dx = dx.reshape(*dx.shape[:-2], n, segment_len, dx.shape[-1])
    return dx.mean(dim=-2)
