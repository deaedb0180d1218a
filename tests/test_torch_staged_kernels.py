"""The orders of work of two redesigned CUDA kernels, checked on the CPU.

``rglru_scan``'s staged kernel computes a tile's gates a_t = exp(la·r_t)
and b_t = sqrt(max(1 − a_t², 1e-12))·(i_t·x_t) for every step first, and
only then walks h = a·h + b down the tile, tile after tile; a torch
emulation of that order, kept here, must equal the plain version bit for
bit (each element goes through the same float32 operations) and agree
with the reference's Pallas kernel (interpret mode) within 1e-5 +
1e-5·|ref|, the scans' tolerance.  ``ccg_solve``'s table kernel builds
a_max·sat per (version, option) and the recourse of every version subset
at every pole once, each subset from the one with its lowest bit cleared;
the table must equal the masked K-fold min (the plain version's recourse)
and the robust problem's cached lookup everywhere, and a solve that reads
every accuracy base and recourse value from the tables must equal the
plain version and the live JAX ``ccg_solve`` exactly.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax.numpy as jnp
from repro.core import cost_model as jcm
from repro.core.robust import RobustProblem as JProb
from repro.kernels.ccg_solve.ops import ccg_solve as j_ccg_solve
from repro.kernels.rglru.kernel import rglru_scan as j_pallas
from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.lattice import BIG
from repro_torch.core.robust import RobustProblem
from repro_torch.core.router import stage1_configure
from repro_torch.kernels.ccg_solve.ref import _first_index, ccg_solve_ref
from repro_torch.kernels.rglru.ref import rglru_scan_ref
from repro_torch.serving.simulator import SimConfig, Simulator

SCAN_TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- rglru_scan

def staged_scan(x, r, i, la, h0=None, tile=32):
    """The staged kernel's order: per tile of ``tile`` steps, every gate
    first, then the chain; the state carried across tiles."""
    b, s, w = x.shape
    h = torch.zeros((b, w)) if h0 is None else h0.clone()
    ys = []
    for t0 in range(0, s, tile):
        sl = slice(t0, min(t0 + tile, s))
        a = torch.exp(la[None, None] * r[:, sl])
        g = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
            i[:, sl] * x[:, sl].float())
        for t in range(a.shape[1]):
            h = a[:, t] * h + g[:, t]
            ys.append(h)
    return torch.stack(ys, dim=1), h


def _rglru_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    sig = lambda a: (1.0 / (1.0 + np.exp(-a))).astype(np.float32)
    return (rng.normal(size=(b, s, w)).astype(np.float32),
            sig(rng.normal(size=(b, s, w))), sig(rng.normal(size=(b, s, w))),
            (-8.0 * np.log1p(np.exp(rng.normal(size=w)))).astype(np.float32),
            rng.normal(size=(b, w)).astype(np.float32))


@pytest.mark.parametrize("tile", [32, 16])
@pytest.mark.parametrize("s,block_t", [(37, 37), (80, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_rglru_order_matches_plain_and_pallas(s, block_t, tile,
                                                     dtype):
    """Tiles that cross S = 37 and S = 80 (a partial last tile, and the
    8 × 80 prefill's three); x in float32 and bf16; h0 given."""
    b, w = 2, 64
    x, r, i, la, h0 = _rglru_inputs(b, s, w, seed=s + tile)
    tx = torch.from_numpy(x).to(dtype)
    tr, ti, tla, th0 = (torch.from_numpy(a) for a in (r, i, la, h0))
    y, h = staged_scan(tx, tr, ti, tla, th0, tile=tile)
    want_y, want_h = rglru_scan_ref(tx, tr, ti, tla, th0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    jy, jh = j_pallas(jnp.asarray(tx.float().numpy()),
                      *(jnp.asarray(a) for a in (r, i, la, h0)),
                      block_t=block_t, block_w=32, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SCAN_TOL)


# ----------------------------------------------------------------- ccg_solve

def subset_table(b2_flat, u_all):
    """(P, 2^K, F) recourse of every version subset at every pole, each
    subset from the one with its lowest bit cleared, as the kernel builds
    it: rec[0] = BIG, rec[c] = min(rec[c & (c − 1)], cost of c's lowest
    bit), the cost b2·(1 + u)."""
    f, k = b2_flat.shape
    cost = b2_flat.t()[None] * (1.0 + u_all)[:, :, None]     # (P, K, F)
    rec = [torch.full((u_all.shape[0], f), BIG)]
    for c in range(1, 2 ** k):
        low = (c & -c).bit_length() - 1
        rec.append(torch.minimum(rec[c & (c - 1)], cost[:, low]))
    return torch.stack(rec, dim=1)


def masked_min_table(b2_flat, u_all):
    """The plain version's recourse: BIG, then the masked running min over
    the versions in order, for every subset."""
    f, k = b2_flat.shape
    p = u_all.shape[0]
    out = torch.empty((p, 2 ** k, f))
    for c in range(2 ** k):
        v = torch.full((p, f), BIG)
        for j in range(k):
            term = b2_flat[None, :, j] * (1.0 + u_all)[:, j, None]
            if (c >> j) & 1:
                v = torch.minimum(v, term)
        out[:, c] = v
    return out


def test_subset_table_equals_masked_min_at_paper_config():
    prob = RobustProblem.build(SystemConfig(), "cpu")
    lat = prob.lat
    table = subset_table(lat.b2_flat, prob.u_all)
    k = lat.sys.num_versions
    assert table.shape == (prob.u_all.shape[0], 2 ** k, lat.n_flat)
    assert torch.equal(table, masked_min_table(lat.b2_flat, prob.u_all))
    # the robust problem's cached (P, F, 2^K) lookup, port and reference
    assert torch.equal(table, prob.rec_table.permute(0, 2, 1))
    jprob = JProb.build(jcm.SystemConfig())
    np.testing.assert_array_equal(
        table.numpy(), np.asarray(jprob.rec_table).transpose(0, 2, 1))


def table_solve(z, aq, rn, pn, tier, b2_flat, u_all, c1, warm_y, margin, k,
                max_iters=8, theta=1e-4):
    """The table kernel's solve in torch: a_max·sat per (version, option)
    and the subset recourse built once; per task the difficulty terms and
    K subtract/clamp/test steps, every recourse value one lookup; then the
    plain version's masked alternation."""
    m, f, p = z.shape[0], rn.shape[0], u_all.shape[0]
    kf = torch.arange(k, dtype=torch.float32)[:, None]
    ams = (0.60 + 0.045 * kf + 0.04 * tier[None]) * (
        1.0 - torch.exp(-(2.5 + 0.3 * kf) * rn[None]))        # (K, F)
    rec = subset_table(b2_flat, u_all)                        # (P, 2^K, F)
    zp = 0.10 * z[:, None] * (1.0 - pn[None])
    zr = 0.06 * z[:, None] * (1.0 - rn[None])
    thr = (aq + margin)[:, None]
    code = torch.zeros((m, f), dtype=torch.int64)
    for j in range(k):
        acc = torch.clamp(ams[j][None] - zp - zr, 0.0, 1.0)
        code |= (acc >= thr).long() << j
        if j == 0:
            bv, bk = acc, torch.zeros((m, f), dtype=torch.int64)
        else:
            up = acc > bv
            bv, bk = torch.where(up, acc, bv), torch.where(up, j, bk)
    by = _first_index(bv == bv.amax(1)[:, None], f)
    best = by * k + bk.gather(1, by[:, None])[:, 0]
    fs_ok = code > 0
    rows = torch.arange(m)

    def worst(y):
        sp = rec[:, code[rows, y], y].t()                     # (M, P)
        q = sp.amax(1)
        return q, _first_index(sp == q[:, None], p)

    def rec_at(pole):
        return rec[pole[:, None], code, torch.arange(f)[None]]  # (M, F)

    warm_y = warm_y.long()
    wyc = warm_y.clamp_min(0)
    use_warm = (warm_y >= 0) & fs_ok[rows, wyc]
    q_w, warm_pole = worst(wyc)
    o_up = torch.where(use_warm, c1[wyc] + q_w, BIG)
    eta = torch.where(use_warm[:, None], rec_at(warm_pole), 0.0)
    o_down = torch.full((m,), -BIG)
    y_best, iters = wyc, torch.zeros(m, dtype=torch.int32)
    done = torch.zeros(m, dtype=torch.bool)
    for _ in range(min(max_iters, p + 1)):
        live = ~done
        obj = torch.where(fs_ok, c1[None] + eta, BIG)
        od = obj.amin(1)
        y_star = _first_index(obj == od[:, None], f)
        q, pole = worst(y_star)
        cand = c1[y_star] + q
        up_new = torch.minimum(o_up, cand)
        y_best = torch.where(live & (cand < o_up), y_star, y_best)
        o_down = torch.where(live, od, o_down)
        o_up = torch.where(live, up_new, o_up)
        eta = torch.maximum(eta, rec_at(pole))
        iters += live.int()
        done = torch.where(live, (up_new - od) <= theta, done)
    _, wp = worst(y_best)
    code_y = code[rows, y_best]
    feas = ((code_y[:, None] >> torch.arange(k)[None]) & 1) > 0
    vals = torch.where(feas, b2_flat[y_best] * (1.0 + u_all[wp]), BIG)
    v_star = _first_index(vals == vals.amin(1)[:, None], k)
    none_ok = ~fs_ok.any(1)
    return (torch.where(none_ok, best // k, y_best).int(),
            torch.where(none_ok, best % k, v_star).int(), o_up, o_down,
            iters, none_ok)


@pytest.mark.parametrize("jforce", ["ref", "pallas"])
@pytest.mark.parametrize("m,rnd", [(48, 0), (48, 3), (130, 1)])
def test_table_solve_matches_plain_and_jax(m, rnd, jforce):
    """``sample_stream`` rounds warm-started from Stage 1, as the main
    path solves them, plus a few cold lanes."""
    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, "cpu")
    lat = prob.lat
    obs = Simulator(sys_, SimConfig(n_tasks=m, seed=rnd),
                    device="cpu").sample_stream(n_rounds=rnd + 1)
    z, aq = obs.z[rnd].contiguous(), obs.aq[rnd].contiguous()
    route, r = stage1_configure(lat, z, z, aq,
                                torch.full((m,), -1, dtype=torch.int64),
                                torch.zeros_like(z))
    wy = lat.flatten_index(route, r, sys_.n_fps - 1).to(torch.int32)
    wy[::7] = -1
    args = (z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat, lat.b2_flat,
            prob.u_all, lat.c1_flat, wy)
    margin, k = sys_.acc_margin_robust, sys_.num_versions
    got = table_solve(*args, margin, k)
    want = ccg_solve_ref(*args, margin, k, 8, 1e-4)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jsys = jcm.SystemConfig()
    jprob = JProb.build(jsys)
    jl = jprob.lat
    jwant = j_ccg_solve(jnp.asarray(z.numpy()), jnp.asarray(aq.numpy()),
                        jl.rn_flat, jl.pn_flat, jl.tier_flat, jl.b2_flat,
                        jprob.poles * jl.u_dev, jl.c1_flat,
                        jnp.asarray(wy.numpy()), margin=jsys.acc_margin_robust,
                        num_versions=k, block_m=16, force=jforce)
    for g, w in zip(got, jwant):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
