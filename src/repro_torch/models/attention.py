"""GQA attention: port of ``repro/models/attention.py`` (specs, the per-head
qk-norm, ``attn_forward``) on the two attention kernels.

On the kernel path the prefill runs ``kernels/flash_attention`` (in
``train`` mode, or wherever a gradient is needed, through its autograd
function ``FlashAttentionFn``, whose backward is the backward kernel) and
each decode step ``kernels/decode_attention``.  The plain path runs
:func:`chunked_attention` and :func:`decode_attention`, ports of the
reference model's jnp code with its roundings (in a bf16 model the score
product is rounded to bf16 before the float32 softmax; the kernels keep
the scores in float32).  ``ctx.force`` chooses as on every kernel wrapper:
the kernels for CUDA tensors, the plain functions for CPU tensors.

The decode step writes its K/V row into the cache slab in place (the
reference returns an updated copy); the slab is the caller's and every
later step reads it.  Where a window binds (``sk > window + q_chunk``),
:func:`chunked_attention` takes the reference's O(S·W) path,
``_windowed_blocks``: one softmax over the gathered ``window + q_chunk``
key span, normalised before the product with v.  Its roundings differ from
the online softmax's, so the two paths are kept apart as in the reference.

Prefill positions: the kernel takes the caller's runtime positions (the
M-RoPE temporal stream, or any (B, S) positions the caller passed) and
masks by them; positions that ``forward`` built itself as ``arange(S)``
keep the index-causal launch.

Split over ``"model"`` (training on a mesh, :func:`attn_tp`): ``wq``,
``wk``, ``wv`` and their biases are column-parallel by heads and ``wo``
row-parallel, its product summed over ``"model"``; the attention (the
kernel and its backward on the card) runs on the rank's ``H/T`` query
heads and the KV heads they read.  Where ``kv_heads`` does not split
evenly (the placement leaves ``wk``/``wv`` whole or cuts them mid-head)
they are read whole and each rank takes the KV head its query heads read
(``"kv_whole"``); where the query heads do not split, the layer runs whole
on every rank.

Under the serve rules (a prefill or decode step on a mesh, the weights the
rank's blocks as plain tensors) the projections split as above, and the
KV cache is split by sequence over ``"model"``: rank r of T holds entries
``[r·C/T, (r+1)·C/T)`` of every row's cache of C entries (``Ctx.cache_len``),
or all of it where T does not divide C (``fitted_spec`` drops the split).
The prefill runs the attention on the rank's heads and emits the gathered
K/V's range.  A decode step (:func:`_decode_split`) gathers the new
token's q, k and v to all heads, writes k/v on the rank that owns slot
``length mod C``, attends over the rank's range with
``decode_attention_partial`` and merges the ranges with
``combine_partials`` (by their log-sum-exps, in rank order); the rank then
takes back its heads for the row-parallel ``wo``.  A kv_whole layer
computes every KV head from its whole ``wk``/``wv`` (the cache holds them
all) and attends with the one its query heads read.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Ctx, apply_mrope, apply_rope, needs_grad
from repro_torch.models.params import ParamSpec
from repro_torch.sharding import tensor_parallel as tp

NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s_in = d ** -0.5
    s_out = (h * hd) ** -0.5 / math.sqrt(2 * cfg.num_layers)
    specs = {
        "wq": ParamSpec((d, h * hd), axes=("embed", "heads_flat"),
                        stddev=s_in),
        "wk": ParamSpec((d, kv * hd), axes=("embed", "heads_flat"),
                        stddev=s_in),
        "wv": ParamSpec((d, kv * hd), axes=("embed", "heads_flat"),
                        stddev=s_in),
        "wo": ParamSpec((h * hd, d), axes=("heads_flat", "embed"),
                        stddev=s_out),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h * hd,), axes=("heads_flat",), init="zeros")
        specs["bk"] = ParamSpec((kv * hd,), axes=("heads_flat",),
                                 init="zeros")
        specs["bv"] = ParamSpec((kv * hd,), axes=("heads_flat",),
                                 init="zeros")
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), axes=("head_dim",),
                                     dtype="float32", init="ones")
        specs["k_norm"] = ParamSpec((hd,), axes=("head_dim",),
                                     dtype="float32", init="ones")
    return specs


def attn_tp(cfg: ModelConfig, rules) -> tp.Plan:
    """The layer's mode over ``"model"`` under ``rules``: ``"split"`` (the
    query and KV projections by heads), ``"kv_whole"`` (the query heads
    split; ``wk``/``wv`` whole, each rank reading the one KV head of its
    query heads, their gradients partial) or ``"whole"``.  The per-head
    norms are read whole on a rank's heads: partial gradients."""
    specs = attn_specs(cfg)
    t = tp.rules_size(rules)
    if t == 1:
        return tp.whole_plan(specs)
    dims = tp.split_dims(specs, rules)
    h, kv = cfg.num_heads, cfg.num_kv_heads
    # the heads dim of each: the weights' columns, the biases', wo's rows
    heads_dim = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
                 "wo": 0}
    q_names = [n for n in ("wq", "bq", "wo") if n in specs]
    kv_names = [n for n in ("wk", "wv", "bk", "bv") if n in specs]
    norms = [n for n in ("q_norm", "k_norm") if n in specs]
    by_heads = lambda names: all(dims[n] == heads_dim[n] for n in names)
    if h % t or not by_heads(q_names):
        return tp.whole_plan(specs)
    if kv % t == 0 and by_heads(kv_names):
        return tp.plan_of(specs, "split", blocks=q_names + kv_names,
                          partial=norms)
    if (h // kv) % (h // t) == 0:
        return tp.plan_of(specs, "kv_whole", blocks=q_names,
                          partial=norms + kv_names)
    return tp.whole_plan(specs)


def _head_rmsnorm(x, scale, eps):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain paths (the reference model's jnp code)
# q: (B, Sq, H, D)  k/v: (B, Sk, KV, D)
# ---------------------------------------------------------------------------
def chunked_attention(q, k, v, positions, *, window: Optional[int] = None,
                      q_chunk: int = 1024, k_chunk: int = 1024):
    """positions: (B, S) token positions of both q and k (self-attention).

    Padded keys get position 2^30 so causality masks them.  Where a window
    binds (``sk > window + q_chunk``), one softmax a q chunk over its
    gathered key span (the reference's ``_windowed_blocks``); otherwise an
    online softmax over (q chunk × k chunk) blocks (``_full_blocks``).
    """
    b, sq, h, d = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    scale = d ** -0.5
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, sk)
    sq_pad, sk_pad = (-sq) % q_chunk, (-sk) % k_chunk
    q_pos = k_pos = positions.to(torch.int32)
    if sq_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, sq_pad))
        q_pos = torch.nn.functional.pad(q_pos, (0, sq_pad))
    if sk_pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, sk_pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, sk_pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, sk_pad), value=2 ** 30)
    orig_sq, sq, sk = sq, sq + sq_pad, sk + sk_pad
    nq = sq // q_chunk

    # (nq, B, KV, G, Cq, D) and (nq, B, Cq)
    qg = q.reshape(b, nq, q_chunk, kvh, g, d).permute(1, 0, 3, 4, 2, 5)
    qp = q_pos.reshape(b, nq, q_chunk).transpose(0, 1)
    if window is not None and sk > window + q_chunk:
        out = _windowed_blocks(qg, qp, k, v, k_pos, window, q_chunk, scale)
    else:
        out = _full_blocks(qg, qp, k, v, k_pos, window, k_chunk, scale)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d)
    return out[:, :orig_sq]


def _mask(q_p, kp, window):
    """(B, Cq, Ck): query position >= key position, within the window."""
    mask = q_p[:, :, None] >= kp[:, None, :]
    if window is not None:
        mask &= q_p[:, :, None] - kp[:, None, :] < window
    return mask


def _full_blocks(qg, qp, k, v, k_pos, window, k_chunk, scale):
    nq, b, kvh, g, cq, d = qg.shape
    sk = k.shape[1]
    nk = sk // k_chunk
    # (nk, B, KV, Ck, D) and (nk, B, Ck)
    kb = k.transpose(1, 2).reshape(b, kvh, nk, k_chunk, d).permute(2, 0, 1, 3, 4)
    vb = v.transpose(1, 2).reshape(b, kvh, nk, k_chunk, d).permute(2, 0, 1, 3, 4)
    kpb = k_pos.reshape(b, nk, k_chunk).transpose(0, 1)
    outs = []
    for qi in range(nq):
        q_blk, q_p = qg[qi], qp[qi]
        m = torch.full((b, kvh, g, cq), NEG_INF, device=qg.device)
        l = torch.zeros((b, kvh, g, cq), device=qg.device)
        acc = torch.zeros((b, kvh, g, cq, d), device=qg.device)
        for ki in range(nk):
            k_blk, v_blk, kp = kb[ki], vb[ki], kpb[ki]
            s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk).float()
            s = s * scale
            s = torch.where(_mask(q_p, kp, window)[:, None, None], s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqc,bkcd->bkgqd", p.to(v_blk.dtype),
                              v_blk).float()
            acc = acc * corr[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(qg.dtype))
    return torch.stack(outs)                          # (nq, B, KV, G, Cq, D)


def _windowed_blocks(qg, qp, k, v, k_pos, window, q_chunk, scale):
    """Only the (window + q_chunk) key span of each q chunk: O(S·W)."""
    nq = qg.shape[0]
    sk = k.shape[1]
    span = min(window + q_chunk, sk)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)     # (B, KV, Sk, D)
    outs = []
    for qi in range(nq):
        q_blk, q_p = qg[qi], qp[qi]
        k_start = min(max(qi * q_chunk + q_chunk - span, 0),
                      max(sk - span, 0))
        k_blk = kt[:, :, k_start:k_start + span]
        v_blk = vt[:, :, k_start:k_start + span]
        kp = k_pos[:, k_start:k_start + span]
        s = torch.einsum("bkgqd,bkcd->bkgqc", q_blk, k_blk).float() * scale
        s = torch.where(_mask(q_p, kp, window)[:, None, None], s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        outs.append(torch.einsum("bkgqc,bkcd->bkgqd",
                                 (p / torch.clamp_min(l, 1e-30)).to(
                                     v_blk.dtype), v_blk))
    return torch.stack(outs)


def decode_attention(q, k_cache, v_cache, *, length):
    """Single-token attention against a cache: q (B, 1, H, D), caches
    (B, S, KV, D), ``length`` a scalar or (B,) count of valid entries
    (every slot < min(length, S) is valid)."""
    b, _, h, d = q.shape
    s, kvh = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, d)
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * d ** -0.5
    lengths = torch.broadcast_to(torch.atleast_1d(length), (b,))
    valid = torch.arange(s, device=q.device)[None, :] < \
        torch.clamp_max(lengths, s)[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, d)


# ---------------------------------------------------------------------------
# Full attention block forward
# ---------------------------------------------------------------------------
def _prefill_attention(ctx: Ctx, q, k, v, positions, positions_given):
    cfg = ctx.cfg
    if _build.dispatch("flash_attention", ctx.force, q.device):
        # positions that forward built are arange(S): causality by index;
        # the caller's positions go to the kernel, which masks by them.
        # Training (or any caller that needs a gradient) goes through the
        # autograd function, whose backward is the backward kernel
        fn = flash_ops.flash_attention_autograd if needs_grad(ctx, q, k, v) \
            else flash_ops.flash_attention
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 window=cfg.attn_window, causal=True,
                 positions=positions if positions_given else None,
                 force="kernel")
        return out.transpose(1, 2)
    return chunked_attention(q, k, v, positions, window=cfg.attn_window,
                             q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk)


def _decode_attention(ctx: Ctx, q, k_cache, v_cache, length):
    if _build.dispatch("decode_attention", ctx.force, q.device):
        b, s = q.shape[0], k_cache.shape[1]
        n = torch.clamp_max(torch.broadcast_to(torch.atleast_1d(length), (b,)),
                            s).to(torch.int32)
        out = decode_ops.decode_attention(
            q[:, 0], k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3),
            n, force="kernel")
        return out[:, None]
    return decode_attention(q, k_cache, v_cache, length=length)


def _seq_block(ctx: Ctx, t):
    """This rank's range of a whole (B, C, KV, D) cache tensor, or all of
    it where the cache stays whole; the mode recorded in ``tp.MODES``."""
    tp.MODES[("attn_cache", "seq" if ctx.cache_split else "whole")] += 1
    if not ctx.cache_split:
        return t
    n = ctx.cache_len // tp.size(ctx)
    return t.narrow(1, tp.rank(ctx.mesh) * n, n).contiguous()


def _decode_split(ctx: Ctx, mode: str, q, k, v, cache):
    """A decode step's attention under the serve rules: q (B, 1, h, D) on
    the rank's heads (all of them in a whole layer), k/v (B, 1, kv, D) the
    rank's KV heads (every one in kv_whole and whole layers); ``cache`` the
    rank's block {k, v: (B, C/T or C, KV, D), length}.  Returns (out
    (B, 1, h, D) on the rank's heads, the cache written in place)."""
    mesh, t, r = ctx.mesh, tp.size(ctx), tp.rank(ctx.mesh)
    h_loc = q.shape[2]
    if mode != "whole":
        q = tp.gather_from_model(q, mesh, dim=2)
    if mode == "split":
        k = tp.gather_from_model(k, mesh, dim=2)
        v = tp.gather_from_model(v, mesh, dim=2)
    idx = cache["length"]
    k_cache, v_cache = cache["k"], cache["v"]
    b, n = q.shape[0], k_cache.shape[1]
    total, split = ctx.cache_len, ctx.cache_split
    if n != (total // t if split else total):
        raise ValueError(f"a rank's cache of {n} entries for a whole cache "
                         f"of {total} on {t} ranks")
    tp.MODES[("attn_cache", "seq" if split else "whole")] += 1
    first = r * n if split else 0
    lengths = torch.broadcast_to(torch.atleast_1d(idx), (b,))
    # rolling-window write position (== length for full caches), written
    # by the rank whose range holds it
    wpos = torch.remainder(lengths, total).long()
    mine = (wpos >= first) & (wpos < first + n)
    slot = torch.where(mine, wpos - first, 0)
    rows = torch.arange(b, device=q.device)
    for c_, new in ((k_cache, k), (v_cache, v)):
        c_[rows, slot] = torch.where(mine[:, None, None], new[:, 0],
                                     c_[rows, slot])
    local = torch.clamp(torch.clamp_max(lengths + 1, total) - first, 0, n)
    out, lse = decode_ops.decode_attention_partial(
        q[:, 0], k_cache.permute(0, 2, 1, 3), v_cache.permute(0, 2, 1, 3),
        local.to(torch.int32), force=ctx.force)
    if split:
        out, _ = tp.combine_partials(out, lse, mesh)
    out = out.to(q.dtype)[:, None]
    if mode != "whole":
        out = out[:, :, r * h_loc:(r + 1) * h_loc]
    return out, {"k": k_cache, "v": v_cache, "length": idx + 1}


def attn_forward(ctx: Ctx, p, x, *, positions, cache=None,
                 cache_out_len: Optional[int] = None,
                 positions_given: bool = False):
    """x: (B, S, d); positions: (B, S), or (B, 3, S) for M-RoPE (whose
    temporal stream drives causality).  Decode (``ctx.mode == "decode"``):
    ``cache`` = {k, v: (B, C, KV, D), length: scalar or (B,)}, written in
    place at ``length mod C``.  Prefill: emits a cache of ``cache_out_len``
    entries when given; ``positions_given``: the caller passed the
    positions (the kernel masks by them).  Returns (y, new_cache or None)."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mode = tp.layer_mode(ctx, "attn", attn_tp)
    wk, wv, bk, bv = p["wk"], p["wv"], p.get("bk"), p.get("bv")
    kv_head = None      # serving kv_whole: the KV head this rank attends with
    if mode != "whole":
        t = tp.size(ctx)
        x = tp.copy_to_model(x, ctx.mesh)
        h //= t
        if mode == "split":
            kv //= t
        elif ctx.mode != "train":   # every KV head, for the cache
            kv_head = tp.rank(ctx.mesh) * h // (h * t // kv)
        else:   # the one KV head that this rank's query heads read
            first = tp.rank(ctx.mesh) * h // (h * t // kv) * hd
            c = slice(first, first + hd)
            kv = 1
            wk, wv = wk[:, c], wv[:, c]
            if cfg.qkv_bias:
                bk, bv = bk[c], bv[c]

    q = x @ p["wq"]
    k = x @ wk
    v = x @ wv
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + bk
        v = v + bv
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = _head_rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = _head_rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        pos_scalar = positions[:, 0]     # the temporal stream: causality
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        pos_scalar = positions

    new_cache = None
    if ctx.mode == "decode" and tp.size(ctx) > 1:
        out, new_cache = _decode_split(ctx, mode, q, k, v, cache)
    elif ctx.mode == "decode":
        idx = cache["length"]            # scalar or (B,) per-row progress
        k_cache, v_cache = cache["k"], cache["v"]
        # rolling-window write position (== idx for full caches)
        wpos = torch.broadcast_to(torch.remainder(idx, k_cache.shape[1]),
                                  (b,)).long()
        rows = torch.arange(b, device=x.device)
        k_cache[rows, wpos] = k[:, 0]
        v_cache[rows, wpos] = v[:, 0]
        out = _decode_attention(ctx, q, k_cache, v_cache, idx + 1)
        new_cache = {"k": k_cache, "v": v_cache, "length": idx + 1}
    else:
        k_att, v_att = (k, v) if kv_head is None else (
            k[:, :, kv_head:kv_head + 1], v[:, :, kv_head:kv_head + 1])
        out = _prefill_attention(ctx, q, k_att, v_att, pos_scalar,
                                 positions_given)
        if cache_out_len is not None:
            keep = min(cache_out_len, s)
            k_keep, v_keep = k[:, s - keep:], v[:, s - keep:]
            if mode == "split":                         # every KV head
                k_keep, v_keep = (tp.gather_from_model(t_, ctx.mesh, dim=2)
                                  for t_ in (k_keep, v_keep))
            if keep < cache_out_len:
                pad = (0, 0, 0, 0, 0, cache_out_len - keep)
                k_keep = torch.nn.functional.pad(k_keep, pad)
                v_keep = torch.nn.functional.pad(v_keep, pad)
            if tp.size(ctx) > 1:        # the rank's range of the sequence
                k_keep, v_keep = (_seq_block(ctx, t_)
                                  for t_ in (k_keep, v_keep))
            new_cache = {"k": k_keep, "v": v_keep,
                         "length": torch.tensor(s, dtype=torch.int32,
                                                device=x.device)}
    y = out.reshape(b, s, h * hd) @ p["wo"]
    if mode != "whole":
        y = tp.reduce_from_model(y, ctx.mesh)
    return y, new_cache
