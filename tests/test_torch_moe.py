"""The port's MoE (``repro_torch.models.moe``) and its tier models against
the live JAX package on identical numpy inputs, in float32 compute on both
sides.

* Routing: the expert ids, the keep mask and the positions in expert are
  exact (integers from the same float32 logits; top-k ties to the lower
  index), also where capacity binds and under forced exact ties.
* ``moe_forward``: y within 1e-5 absolute (the grouped products sum in
  another order), the load-balancing loss within 1e-6 relative.
* ``quantize_expert_params``: int8 weights exact, scales within one ulp.
* Moonshot-v1-16B-A3B and Mixtral-8x22B SMOKE through prefill, the slab
  and four decode steps: logits within 1e-4, caches within 1e-5 (the
  tolerances of ``test_torch_model.py``); the executor with a MoE cloud
  pool against the serial oracle (exact ids: the SMOKE configs'
  capacity factor of 8 drops nothing) and the live JAX executor.
* ``init_params`` draws a leaf of more than 2^32 elements one slice of its
  leading axis at a time; every leaf at or under it keeps its whole draw.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch
from test_torch_dispatch import (
    _executor_matches_jax_executor,
    _f32_pools,
    _ids,
    _mixed_requests,
)
from test_torch_model import _check, _Runs
from test_torch_model import test_kernel_branch_wiring as _kernel_wiring

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.models import Ctx as JCtx
from repro.models import model_specs as j_model_specs
from repro.models import prefill as j_prefill
from repro.models.moe import moe_forward as j_moe_forward
from repro.models.moe import moe_specs as j_moe_specs
from repro.models.moe import quantize_expert_params as j_quantize
from repro.models.params import init_params as j_init_params
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import model_params_from_numpy, tree_to_numpy
from repro_torch.models import params as params_mod
from repro_torch.models.layers import Ctx
from repro_torch.models.model import model_specs, prefill
from repro_torch.models.moe import (
    moe_forward,
    moe_specs,
    quantize_expert_params,
    route,
    top_k_first,
)
from repro_torch.models.params import (
    ParamSpec,
    init_params,
    tree_leaves,
    tree_map,
)
from repro_torch.serving.dispatch import DispatchExecutor, serve_serial_oracle
from repro_torch.serving.pools import make_tier_pools

MOE = ("moonshot-v1-16b-a3b", "mixtral-8x22b")
Y_ATOL = 1e-5
AUX_RTOL = 1e-6


def _cfgs(arch, **moe_kw):
    """(reference, port) SMOKE configs in float32 compute, the MoE
    sub-config's fields replaced by ``moe_kw``."""
    out = []
    for c in (j_smoke(arch), get_smoke_config(arch)):
        c = dataclasses.replace(c, compute_dtype="float32")
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe,
                                                               **moe_kw))
        out.append(c)
    return out


def _layer_params(jcfg, seed=0):
    """One layer's MoE parameters from the reference's init, as numpy."""
    p = j_init_params(j_moe_specs(jcfg), jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


def _torch(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(jcfg, b=3, s=10, seed=1):
    return np.random.default_rng(seed).normal(
        size=(b, s, jcfg.d_model)).astype(np.float32)


def _j_route(jcfg, logits):
    """The reference's routing lines (``moe_forward``, one group) on float32
    logits (t, E): ids (t, k), positions in expert and keep (t·k,)."""
    e = jcfg.moe
    t, k = logits.shape[0], e.top_k
    cap = int(math.ceil(t * k / e.num_experts * e.capacity_factor))
    cap = min(max(cap, e.min_capacity), t * k)
    weights, ids = jax.lax.top_k(logits, k)
    flat = ids.reshape(t * k)
    onehot = jax.nn.one_hot(flat, e.num_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=0) * onehot).sum(-1) - 1
    return (np.asarray(ids), np.asarray(pos), np.asarray(pos < cap), cap,
            np.asarray(jax.nn.softmax(weights, axis=-1)))


def _check_forward(jcfg, cfg, p, x, tp=None):
    """The routing of the reference's logits, then y and aux end to end;
    returns the number of dropped slots."""
    jy, jaux = j_moe_forward(JCtx(cfg=jcfg), jax.tree_util.tree_map(
        jnp.asarray, p), jnp.asarray(x))
    y, aux = moe_forward(Ctx(cfg=cfg), tp or _torch(p), torch.from_numpy(x))
    logits = x.reshape(-1, jcfg.d_model) @ np.asarray(p["router"])
    jids, jpos, jkeep, jcap, jw = _j_route(jcfg, jnp.asarray(logits))
    flat_ids, flat_w, pos, keep, cap, ids = route(cfg, torch.from_numpy(
        logits))
    assert cap == jcap
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_allclose(flat_w.numpy(), jw.reshape(-1), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=Y_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    return int((~keep).sum())


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    assert _check_forward(jcfg, cfg, _layer_params(jcfg), _x(jcfg)) == 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_drops_the_same_slots_when_capacity_binds(arch):
    """capacity_factor 1, min_capacity 1: cap = ceil(t·k/E), under the
    busiest experts' load; the same slots are dropped (their combine weight
    counts zero) in the reference's slot order."""
    jcfg, cfg = _cfgs(arch, capacity_factor=1.0, min_capacity=1)
    dropped = _check_forward(jcfg, cfg, _layer_params(jcfg, 2),
                             _x(jcfg, 4, 12, 3))
    assert dropped > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_breaks_exact_ties_like_reference(arch):
    """Inputs and router in {-1, 0, 1}: the logits are exact integers in
    either framework's summation order, so many tie exactly; top-k takes the
    lower expert first, which fixes the capacity order too."""
    jcfg, cfg = _cfgs(arch, capacity_factor=1.0, min_capacity=1)
    rng = np.random.default_rng(4)
    p = _layer_params(jcfg, 4)
    p["router"] = rng.integers(-1, 2, p["router"].shape).astype(np.float32)
    x = rng.integers(-1, 2, (4, 16, jcfg.d_model)).astype(np.float32)
    logits = x.reshape(-1, jcfg.d_model) @ p["router"]
    k = jcfg.moe.top_k
    top = -np.sort(-logits, axis=-1)
    assert (top[:, k - 1] == top[:, k]).sum() >= 4      # ties at the cut
    _check_forward(jcfg, cfg, p, x)


def test_top_k_first_takes_the_lower_index_among_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]])
    values, ids = top_k_first(logits, 3)
    assert ids.tolist() == [[1, 2, 4], [0, 1, 2]]
    j_values, j_ids = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))


@pytest.mark.parametrize("arch", MOE)
def test_quantized_experts_match_reference(arch):
    """int8 weights exact, float32 per-expert scales within one ulp, and
    ``moe_forward`` on the int8 parameters (each weight times its scale in
    the compute dtype)."""
    jcfg, cfg = _cfgs(arch)
    p = _layer_params(jcfg, 5)
    jq = {k: np.asarray(v) for k, v in j_quantize(
        jax.tree_util.tree_map(jnp.asarray, p)).items()}
    tq = quantize_expert_params(_torch(p))
    assert set(tq) == set(jq)
    for name in ("w_gate", "w_up", "w_down"):
        assert tq[name].dtype == torch.int8
        np.testing.assert_array_equal(tq[name].numpy(), jq[name])
        assert tq[name + "_scale"].shape == jq[name + "_scale"].shape
        np.testing.assert_array_max_ulp(tq[name + "_scale"].numpy(),
                                        jq[name + "_scale"], maxulp=1)
    _check_forward(jcfg, cfg, jq, _x(jcfg, seed=6), tp=tq)
    specs = moe_specs(cfg, quantized=True)
    assert {k: (s.shape, s.dtype) for k, s in specs.items()} == {
        k: (tuple(s.shape), "int8" if s.dtype == jnp.int8 else
            "float32" if k.endswith("_scale") else None)
        for k, s in j_moe_specs(jcfg, quantized=True).items()}


def test_serve_specs_carry_int8_experts_through_prefill():
    """Mixtral's serve-time specs (``quant_experts_serve``): the reference's
    float weights quantized layer by layer, carried across both ways with
    their int8 leaves and float32 scales, then a prefill on them."""
    jcfg, cfg = (dataclasses.replace(c, quant_experts_serve=True)
                 for c in _cfgs("mixtral-8x22b"))
    jp = j_init_params(j_model_specs(jcfg), jax.random.PRNGKey(7))
    seg = jp["segments"][0]["pos0"]
    layers = [j_quantize({k: v[i] for k, v in seg["mlp"].items()})
              for i in range(cfg.num_layers)]
    seg["mlp"] = {k: jnp.stack([layer[k] for layer in layers])
                  for k in layers[0]}
    jp = jax.tree_util.tree_map(np.asarray, jp)
    p = model_params_from_numpy(jp, cfg, "cpu", serve=True)
    mlp = p["segments"][0]["pos0"]["mlp"]
    assert mlp["w_up"].dtype == torch.int8
    assert mlp["w_up_scale"].dtype == torch.float32
    tree_map(lambda x, y: np.testing.assert_array_equal(x, y),
             tree_to_numpy(p), jp)
    toks = np.random.default_rng(8).integers(0, 128, (2, 24)).astype(
        np.int32)
    jl, _ = j_prefill(JCtx(cfg=jcfg), jax.tree_util.tree_map(jnp.asarray, jp),
                      {"tokens": jnp.asarray(toks)})
    tl, _ = prefill(Ctx(cfg=cfg), p, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    assert init_params(model_specs(cfg, serve=True), torch.Generator()
                       .manual_seed(0), "cpu")["segments"][0]["pos0"][
        "mlp"]["w_gate"].dtype == torch.int8


# ---------------------------------------------------------------------------
# The MoE tier models and pools
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_moe_prefill_and_slab_decode_match_reference(arch):
    """Two prompt buckets, the slab (Mixtral's rolling 16-entry window
    wraps over its 24-token prompts) and four decode steps; a decode step
    routes every slot of the slab, the empty one included."""
    under = _check(_Runs(arch, "float32"), "float32")
    print(f"{arch} float32: {under} greedy lanes under the margin")


@pytest.mark.parametrize("arch", MOE)
def test_moe_kernel_branch_wiring(monkeypatch, arch):
    """The MoE models' attention layers take the kernels' branch as the
    dense ones (one flash launch a layer a prefill, one decode launch a
    layer a step, index-causal: no positions)."""
    _kernel_wiring(monkeypatch, arch)


@pytest.mark.parametrize("arch", MOE)
def test_moe_executor_matches_serial_oracle(arch):
    """Qwen1.5-0.5B edge, a MoE cloud (bf16 SMOKE): the executor's bucketed
    prefills and slab decode steps route other token sets than the serial
    path, but with nothing dropped each token's expert mix is its own, so
    the ids are equal request for request."""
    pools = make_tier_pools(get_smoke_config("qwen1.5-0.5b"),
                            get_smoke_config(arch), device="cpu")
    reqs = _mixed_requests(128, m=12, seed=9, decode_tokens=5)
    want = serve_serial_oracle(pools, [dataclasses.replace(r) for r in reqs])
    ex = DispatchExecutor(pools, n_slots=4, max_prefill_batch=2)
    ex.serve(reqs)
    got = _ids(ex)
    assert set(got) == set(want) and {r.tier for r in reqs} == {0, 1}
    for s in want:
        np.testing.assert_array_equal(got[s], want[s],
                                      err_msg=f"stream {s} ids diverge")


@pytest.mark.parametrize("arch", MOE)
def test_moe_executor_matches_jax_executor(arch):
    _executor_matches_jax_executor(*_f32_pools(("qwen1.5-0.5b", arch)))


def test_moe_executor_matches_jax_executor_when_capacity_binds():
    """With drops (capacity factor 1, minimum 1) a token's output depends
    on the other tokens of its call, so the executor cannot equal the
    serial path; it equals the live JAX executor on the same schedule."""
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", capacity_factor=1.0,
                      min_capacity=1)
    jpools, tpools = _f32_pools(("qwen1.5-0.5b", "moonshot-v1-16b-a3b"))
    from repro.serving.pools import ModelPool as JModelPool
    from repro_torch.serving.pools import ModelPool
    jpools[1] = JModelPool(jcfg, jax.random.PRNGKey(2), name="cloud")
    tpools[1] = ModelPool(cfg, name="cloud", device="cpu",
                          params=model_params_from_numpy(
                              jax.tree_util.tree_map(np.asarray,
                                                     jpools[1].params),
                              cfg, "cpu"))
    _executor_matches_jax_executor(jpools, tpools)


# ---------------------------------------------------------------------------
# init_params' sliced draw
# ---------------------------------------------------------------------------
def _whole_draw(specs, gen, dtype):
    """init_params as it drew every leaf before the sliced draw."""
    def make(spec):
        dt = params_mod.leaf_dtype(spec, dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt)
        return torch.randn(spec.shape, generator=gen).mul_(spec.stddev).to(dt)
    return tree_map(make, specs)


def test_init_params_draws_a_large_leaf_in_slices(monkeypatch):
    """Over the threshold (patched to 64 elements here, 2^32 in use) a
    leaf is drawn one slice of its leading axis at a time, in order, from
    the same generator; the leaves after it draw on from there."""
    monkeypatch.setattr(params_mod, "CHUNKED_DRAW_ELEMENTS", 64)
    specs = {"a": ParamSpec((3, 4, 6), stddev=0.5),        # 72: sliced
             "b": ParamSpec((8, 8), stddev=2.0),           # 64: whole
             "c": ParamSpec((5, 13), dtype="int8", stddev=3.0)}
    got = init_params(specs, torch.Generator().manual_seed(11), "cpu",
                      torch.bfloat16)
    gen = torch.Generator().manual_seed(11)
    a = torch.stack([torch.randn((4, 6), generator=gen).mul_(0.5).to(
        torch.bfloat16) for _ in range(3)])
    b = torch.randn((8, 8), generator=gen).mul_(2.0).to(torch.bfloat16)
    c = torch.stack([torch.randn((13,), generator=gen).mul_(3.0).to(
        torch.int8) for _ in range(5)])
    for name, want in (("a", a), ("b", b), ("c", c)):
        assert got[name].dtype == want.dtype
        assert torch.equal(got[name], want), name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "qwen3-8b", "yi-34b",
                                  "minitron-8b", "falcon-mamba-7b",
                                  "recurrentgemma-9b"])
def test_init_params_keeps_the_ported_models_draws(arch):
    """Every leaf of the configs that the card already runs at full size
    (the four tier pools) and of Minitron-8B is at most 2^32 elements
    (Falcon-Mamba's in_proj stack exactly), so each keeps its whole draw.
    Yi-34B's three stacked MLP leaves (60, 7168, 20480) are over it and are
    now sliced: its old whole draw needed a 35 GB float32 temporary beside
    68.7 GB of bf16 weights, which one card never held.  At SMOKE size
    every leaf is the old algorithm's bit for bit."""
    sizes = [math.prod(s.shape) for s in tree_leaves(model_specs(
        get_config(arch)))]
    over = sum(n > params_mod.CHUNKED_DRAW_ELEMENTS for n in sizes)
    assert over == (3 if arch == "yi-34b" else 0)
    specs = model_specs(get_smoke_config(arch))
    got = init_params(specs, torch.Generator().manual_seed(3), "cpu",
                      torch.bfloat16)
    want = _whole_draw(specs, torch.Generator().manual_seed(3),
                       torch.bfloat16)
    tree_map(lambda g, w: torch.testing.assert_close(g, w, rtol=0, atol=0),
             got, want)


def test_moonshot_expert_leaves_are_drawn_in_slices():
    """Moonshot-v1-16B-A3B's stacked expert leaves (48, 64, 2048, 1408)
    are over the threshold, and a slice of one is 1/48 of it."""
    mlp = model_specs(get_config("moonshot-v1-16b-a3b"))["segments"][0][
        "pos0"]["mlp"]
    for name in ("w_gate", "w_up", "w_down"):
        n = math.prod(mlp[name].shape)
        assert n > params_mod.CHUNKED_DRAW_ELEMENTS
        assert n // mlp[name].shape[0] < params_mod.CHUNKED_DRAW_ELEMENTS
