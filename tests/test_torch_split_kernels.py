"""The orders of work of two CUDA kernels, checked on the CPU.

``decode_attention`` splits each row's cache over the blocks of a cluster
(``ops.split_rule``) and combines the splits' partial softmax states in
split order; a torch emulation of that order, kept here, is held to the
plain version and to the reference's Pallas kernel (interpret mode) at the
three serving slabs, within the kernel's own tolerances: 2e-5 + 2e-5·|ref|
in float32, 2e-2 + 2e-2·|ref| in bfloat16 (the probabilities are rounded to
bf16 relative to each split's max, not the row's).  ``lpt_queue``'s walk
keeps each tier's loads sorted by (load, server index) where its inputs
allow, and otherwise takes a balanced-tree argmin whose left operand wins
ties; both must pick the first index of the minimum as the reference's
``argmin`` does (emulations of both, kept here, are held to that); and
its per-server starting loads (the reference's ``avail``) are held to the
reference on the plain path.
"""
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax.numpy as jnp
from repro.kernels.decode_attention.kernel import decode_attention as j_pallas
from repro.serving.simulator import _lpt_queue as j_lpt
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF, \
    decode_attention_ref
from repro_torch.kernels.lpt_queue.ops import lpt_queue

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (B, H, KV, S, D): the edge (Qwen1.5-0.5B), cloud (Qwen3-8B) and
# RecurrentGemma-9B slabs that chip_smoke.py drives
SLABS = {"edge": (16, 16, 16, 144, 64), "cloud": (16, 32, 8, 144, 128),
         "recurrentgemma": (16, 16, 1, 80, 256)}


def _chunks(bkv, s, sms=132):
    n = decode_ops.split_rule(bkv, s, sms)
    chunk = -(-s // n)
    return [(i * chunk, min((i + 1) * chunk, s)) for i in range(n)]


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("bkv", [1, 2, 3, 16, 128, 256, 1000, 70000])
def test_split_rule_covers_the_cache_in_order(bkv, sms):
    """Chunks of ceil(S / splits) entries, as the kernel cuts them: in
    order, none empty, covering [0, S) exactly, at most 8 of them."""
    for s in range(1, 2049):
        chunks = _chunks(bkv, s, sms)
        assert 1 <= len(chunks) <= decode_ops.MAX_SPLITS
        assert chunks[0][0] == 0 and chunks[-1][1] == s
        assert all(lo < hi for lo, hi in chunks)
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))


def test_split_rule_at_the_serving_slabs():
    """Two blocks an SM where the chunks keep 16 entries: 2 / 3 / 5 splits
    at the edge, cloud and RecurrentGemma slabs (RecurrentGemma's 80
    entries cap it at 5)."""
    for (b, _, kv, s, _), splits in zip(SLABS.values(), (2, 3, 5)):
        assert decode_ops.split_rule(b * kv, s) == splits


def split_decode(q, k, v, length, splits):
    """The kernel's order in torch: per split, float32 scores, the split's
    max m, p = exp(s − m), l = Σ p, P rounded to the value type before P·V
    summed in float32; then m = max mᵢ, l = Σ lᵢ·e^(mᵢ−m), acc = Σ
    accᵢ·e^(mᵢ−m) in split order, out = acc / max(l, 1e-30)."""
    b, h, d = q.shape
    kv, s = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, d)
    chunk = -(-s // splits)
    parts = []
    for i in range(splits):
        lo, hi = i * chunk, min((i + 1) * chunk, s)
        sc = torch.einsum("bkgd,bksd->bkgs", qg, k[:, :, lo:hi].float()) \
            * d ** -0.5
        valid = (torch.arange(lo, hi)[None] < length[:, None])[:, None, None]
        m = torch.where(valid, sc, NEG_INF).amax(-1).clamp_min(NEG_INF)
        p = torch.where(valid, torch.exp(sc - m[..., None]), 0.0)
        acc = torch.einsum("bkgs,bksd->bkgd", p.to(v.dtype).float(),
                           v[:, :, lo:hi].float())
        parts.append((m, p.sum(-1), acc))
    m = torch.stack([p[0] for p in parts]).amax(0)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for m_i, l_i, a_i in parts:
        w = torch.exp(m_i - m)
        l = l + l_i * w
        acc = acc + a_i * w[..., None]
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("slab", list(SLABS))
def test_split_combine_matches_plain_and_pallas(slab, dtype):
    b, h, kv, s, d = SLABS[slab]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s + d)
    arrays = []
    for shape in ((b, h, d), (b, kv, s, d), (b, kv, s, d)):
        a = rng.normal(size=shape).astype(np.float32)
        arrays.append(np.array(jnp.asarray(a, jdt).astype(jnp.float32)))
    length = rng.integers(1, s + 1, b).astype(np.int32)
    length[0], length[-1] = 1, s
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    got = split_decode(q, k, v, torch.from_numpy(length),
                       decode_ops.split_rule(b * kv, s))
    want = decode_attention_ref(q, k, v, torch.from_numpy(length))
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    pallas = j_pallas(*(jnp.asarray(a, jdt) for a in arrays),
                      jnp.asarray(length), interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas).astype(np.float32),
                               **TOL[dtype])


def tree_argmin(x):
    """The kernel's ``tree_argmin``: pairs at stride 1, 2, 4, ...; the
    right operand wins only when strictly less."""
    val, idx = list(x), list(range(len(x)))
    w = 1
    while w < len(x):
        for i in range(0, len(x) - w, 2 * w):
            if val[i + w] < val[i]:
                val[i], idx[i] = val[i + w], idx[i + w]
        w *= 2
    return val[0], idx[0]


@pytest.mark.parametrize("n", range(1, 9))
def test_tree_argmin_picks_the_first_minimum(n):
    """Tie-heavy loads on a coarse grid with +inf entries (dead servers,
    and the generic walk's padding to 7 servers): the tree's pick is
    numpy's first-index argmin, its value that load bit for bit."""
    rng = np.random.default_rng(n)
    grid = np.array([0.0, 0.125, 0.25, np.inf], np.float32)
    for _ in range(500):
        x = grid[rng.integers(0, 4, n)]
        best, pick = tree_argmin(x)
        assert pick == int(np.argmin(x)) and best == x[pick]
        if n < 7:
            padded = np.concatenate([x, np.full(7 - n, np.inf, np.float32)])
            assert tree_argmin(padded)[1] == pick


def place_sorted(x, ids, t):
    """The kernel's ``place_sorted`` on float32 loads x sorted by (load,
    server index): returns x[0] and inserts x[0] + t back in order by the
    unsigned compare of float32 bits, + 1 where the index is the larger."""
    start = x[0]
    a = np.float32(x[0] + np.float32(t))
    key = int(a.view(np.uint32))
    n = len(x)
    before = [False] + [key < int(x[k].view(np.uint32)) + (ids[0] < ids[k])
                        for k in range(1, n)]
    nx, nid = list(x), list(ids)
    for k in range(n - 1):
        shifted = k >= 1 and before[k]
        nx[k] = (x[k] if shifted else a) if before[k + 1] else x[k + 1]
        nid[k] = (ids[k] if shifted else ids[0]) if before[k + 1] \
            else ids[k + 1]
    nx[n - 1] = x[n - 1] if n > 1 and before[n - 1] else a
    nid[n - 1] = ids[n - 1] if n > 1 and before[n - 1] else ids[0]
    x[:], ids[:] = nx, nid
    return start


def sorted_walk(t, route, n_edge, n_cloud, init):
    """The kernel's sorted walk over one round (times >= 0, a live cloud
    server): each tier's loads sorted by (load, index), a task placed on
    the first of its tier's."""
    tiers = []
    for lo, hi in ((0, n_edge), (n_edge, n_edge + n_cloud)):
        pairs = sorted((init[j], j) for j in range(lo, hi))
        tiers.append(([np.float32(v) for v, _ in pairs], [j for _, j in pairs]))
    order = np.argsort(-t, kind="stable")
    start = np.zeros_like(t)
    for i in order:
        x, ids = tiers[int(route[i] != 0)]
        start[i] = place_sorted(x, ids, t[i])
    return start


@pytest.mark.parametrize("n_edge,n_cloud,dead", [
    (4, 1, ()), (4, 1, (0, 2)), (1, 1, ()), (7, 1, (3,)), (3, 5, (3, 5)),
    (2, 2, (0, 1)),        # the edge tier dead: its starts are +inf
])
def test_sorted_walk_matches_first_index_argmin(n_edge, n_cloud, dead):
    """Tie-heavy times (a coarse grid, zeros included) and starting loads
    of 0 or +inf: the sorted walk's starts equal the plain version's, bit
    for bit."""
    rng = np.random.default_rng(n_edge * 10 + n_cloud)
    for _ in range(4):
        t = (rng.integers(0, 5, 300) * 0.125).astype(np.float32)
        route = rng.integers(0, 2, 300).astype(np.int32)
        avail = np.ones(n_edge + n_cloud, np.float32)
        avail[list(dead)] = 0.0
        init = np.where(avail > 0, 0.0, np.inf).astype(np.float32)
        want = lpt_queue(torch.from_numpy(t), torch.from_numpy(route),
                         n_edge, n_cloud, avail=torch.from_numpy(avail))
        np.testing.assert_array_equal(
            sorted_walk(t, route, n_edge, n_cloud, init), want.numpy())


@pytest.mark.parametrize("n_edge,n_cloud,dead", [
    (4, 1, ()), (4, 1, (2,)),
    (4, 1, (4,)),          # the cloud tier dead: its tasks land on server 0
    (2, 2, (0, 1)),        # the edge tier dead: its starts are +inf
    (3, 5, (1, 3, 7)),
])
def test_lpt_queue_availability_matches_reference(n_edge, n_cloud, dead):
    rng = np.random.default_rng(n_edge + 3 * len(dead))
    t = (rng.integers(1, 5, (3, 60)) * 0.125).astype(np.float32)
    route = rng.integers(0, 2, (3, 60)).astype(np.int32)
    avail = np.ones((3, n_edge + n_cloud), np.float32)
    avail[1:, list(dead)] = 0.0
    want = np.asarray(j_lpt(jnp.asarray(t), jnp.asarray(route), n_edge,
                            n_cloud, jnp.asarray(avail)))
    got = lpt_queue(torch.from_numpy(t), torch.from_numpy(route), n_edge,
                    n_cloud, avail=torch.from_numpy(avail))
    np.testing.assert_array_equal(got.numpy(), want)
    one = lpt_queue(torch.from_numpy(t[1]), torch.from_numpy(route[1]),
                    n_edge, n_cloud, avail=torch.from_numpy(avail[1]))
    np.testing.assert_array_equal(one.numpy(), want[1])
