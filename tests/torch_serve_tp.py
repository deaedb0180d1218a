"""What each rank of the serve-step test runs (spawned by
``repro_torch.launch.mesh.run_ranks``, so importable and free of JAX): the
port's prefill and serve steps under ``rules_for(cfg, mesh, kind)`` on its
block of the weights, rows and cache, returning numpy results for the test
process to hold."""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import cache_from_numpy, model_params_from_numpy, \
    tree_to_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_prefill_step, make_serve_step, \
    rules_for
from repro_torch.models.model import cache_placements, serve_params
from repro_torch.models.params import block_start, tree_map
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.collectives import shard_count, shard_index


def serve_cfg(arch: str, kw: dict):
    """The float32 SMOKE config of ``arch`` with ``kw`` replaced;
    ``"overrides"`` takes the full config's ``sharding_overrides`` and
    int8 serve-time experts."""
    kw = dict(kw)
    if kw.pop("overrides", False):
        full = get_config(arch)
        kw["sharding_overrides"] = full.sharding_overrides
        kw["quant_experts_serve"] = full.quant_experts_serve
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **kw)


def run_steps(cfg, params, inputs, prefill_rules=None, serve_rules=None,
              rows=slice(None)):
    """A prefill of ``inputs["tokens"][rows]``, the cache's per-row lengths
    set to ``inputs["lengths"][rows]``, then a decode step a column of
    ``inputs["decode"][rows]`` -> (every step's logits, the cache after
    the prefill, the cache after the last step), numpy."""
    prefill_step = make_prefill_step(cfg, prefill_rules)
    serve_step = make_serve_step(cfg, serve_rules)
    tokens = torch.from_numpy(inputs["tokens"][rows])
    with torch.no_grad():
        logits, cache = prefill_step(params, {"tokens": tokens})
        first = tree_to_numpy(cache)
        cache["length"] = torch.from_numpy(inputs["lengths"][rows])
        out = [logits.numpy()]
        for col in inputs["decode"][rows].T:
            logits, cache = serve_step(params, cache, {
                "tokens": torch.from_numpy(np.ascontiguousarray(col[:, None]))})
            out.append(logits.numpy())
    return out, first, tree_to_numpy(cache)


def serve_case(case: dict, params_np, inputs) -> dict:
    """``case`` on a host mesh of its shape: its logits, its caches (the
    rank's blocks) and where its blocks start in the whole cache, the
    modes the layers ran; with ``case["cut"]``, also the one-device
    prefill's cache cut by ``cache_from_numpy(..., placements=, mesh=)``."""
    mesh = make_host_mesh(case["shape"])
    cfg = serve_cfg(case["arch"], case.get("cfg", {}))
    pre, dec = rules_for(cfg, mesh, "prefill"), rules_for(cfg, mesh, "decode")
    whole = model_params_from_numpy(params_np, cfg, "cpu", serve=True)
    n = inputs["tokens"].shape[0] // shard_count(mesh, "data")
    rows = slice(shard_index(mesh, "data") * n,
                 (shard_index(mesh, "data") + 1) * n)
    tp.MODES.clear()
    logits, first, last = run_steps(cfg, serve_params(cfg, whole, dec),
                                    inputs, pre, dec, rows)
    pls = cache_placements(cfg, dec, *inputs["tokens"].shape)
    out = {"logits": logits, "first": first, "last": last,
           "starts": tree_map(lambda pl: np.asarray(block_start(pl, mesh)),
                              pls["segments"]),
           "modes": dict(tp.MODES)}
    if case.get("cut"):
        _, one, _ = run_steps(cfg, whole, inputs)
        out["cut"] = tree_to_numpy(cache_from_numpy(
            one, cfg, "cpu", placements=pls, mesh=mesh))
    return out


def world(cases, params: dict, inputs: dict) -> dict:
    """Every case of one mesh shape, in one world."""
    return {c["name"]: serve_case(c, params[c["name"]], inputs[c["name"]])
            for c in cases}
