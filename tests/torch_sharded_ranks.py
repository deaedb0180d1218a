"""What each rank of a sharded test runs (spawned by
``repro_torch.launch.mesh.run_ranks``, so importable and free of JAX): the
port's sharded serving, sharded solve and elastic runs on numpy inputs,
returning numpy results for the test process to hold against the JAX
reference."""
from __future__ import annotations
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)

import dataclasses

import numpy as np
import torch

from repro_torch.convert import gate_params_from_numpy
from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.gating import GateConfig
from repro_torch.core.robust import RobustProblem, solve_ccg_sharded
from repro_torch.core.router import RouterConfig, shard_bandwidth_target
from repro_torch.launch.mesh import host_mesh
from repro_torch.runtime.cluster import elastic_remesh
from repro_torch.serving.policy import Observation, make_policy
from repro_torch.serving.session import (
    AdmissionConfig,
    ServeSession,
    _shard_stream,
    _ShardPlan,
    _sharded_round,
)
from repro_torch.serving.tree import tree_leaves, tree_map
from repro_torch.sharding.audit import collective_footprint, round_records
from repro_torch.sharding.collectives import shard_index

SYS = SystemConfig()
DEC_KEYS = ("route", "r", "p", "v")


def obs_from_numpy(arrs: dict) -> Observation:
    """An Observation of CPU tensors from the stream fields in ``arrs``."""
    return Observation(**{f.name: torch.from_numpy(np.array(arrs[f.name]))
                          for f in dataclasses.fields(Observation)
                          if f.name in arrs})


def policy(name: str, gate_np=None):
    """A port policy on the CPU; ``r2evid`` in gate mode when the JAX gate
    parameters ``gate_np`` are given."""
    if name == "r2evid" and gate_np is not None:
        return make_policy("r2evid", SYS, device="cpu",
                           gate_cfg=GateConfig(d_feature=35),
                           gate_params=gate_params_from_numpy(gate_np, "cpu"))
    return make_policy(name, SYS, device="cpu")


def to_numpy(out: dict) -> dict:
    return {k: v.numpy().copy() for k, v in out.items()}


def state_leaves(state) -> list:
    return [t.numpy().copy() for t in tree_leaves(state)]


def _refusal(fn) -> str | None:
    """The message of the ValueError ``fn`` raises, None if it returns."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def session_ranks(stream_np: dict, gate_np: dict, uneven_np: dict) -> dict:
    """A rank of the 4-rank session checks: for gate-mode r2evid, rdap and
    sniper in both modes the outputs, final carry and collectives of
    ``run_sharded`` (M = 64, pools 16 / 8); the uneven churned run (M = 13,
    pools 8 / 4) in both modes; the guards; and the hierarchical round
    graph against a plain loop over its round function."""
    mesh = host_mesh()
    stream = obs_from_numpy(stream_np)
    m = stream.z.shape[1]
    res = {"rank": shard_index(mesh), "runs": {}, "uneven": {}}
    for name in ("r2evid", "rdap", "sniper"):
        pol = policy(name, gate_np)
        for hier in (False, True):
            sess = ServeSession(pol, m, device="cpu", n_edge=16, n_cloud=8)
            out = {}
            foot = collective_footprint(
                lambda: out.update(sess.run_sharded(mesh, stream,
                                                    hierarchical=hier)))
            res["runs"][name, hier] = {
                "out": to_numpy(out), "state": state_leaves(sess.state),
                "in_round": round_records(foot)}

    unev = obs_from_numpy(uneven_np)
    m13 = unev.z.shape[1]
    acfg = AdmissionConfig(**{k: int(uneven_np[f"acfg_{k}"])
                              for k in ("max_queue", "init_alive")})
    for hier in (False, True):
        sess = ServeSession(policy("r2evid"), m13, device="cpu", n_edge=8,
                            n_cloud=4, admission=acfg)
        res["uneven"][hier] = to_numpy(sess.run_sharded(mesh, unev,
                                                        hierarchical=hier))

    rdap = policy("rdap")
    res["hedge_refusal"] = _refusal(lambda: ServeSession(
        rdap, m, device="cpu", hedge=(0.9, 0.05), hierarchical=True,
        mesh=mesh).run(stream))
    res["pool_refusal"] = _refusal(lambda: ServeSession(
        rdap, m, device="cpu", n_edge=16, n_cloud=9).run_sharded(
        mesh, stream, hierarchical=True))

    # the hierarchical round graph against a plain loop over its round
    pol = policy("r2evid", gate_np)
    sess = ServeSession(pol, m, device="cpu", n_edge=16, n_cloud=8)
    graphed = sess.run_sharded(mesh, stream, hierarchical=True)
    plan = _ShardPlan.build(pol, mesh, "data", m, n_edge=16, n_cloud=8,
                            hedge=None, acfg=None, hierarchical=True)
    local = _shard_stream(stream, plan)
    carry = tree_map(lambda x: x[plan.local].clone(),
                     pol.pad_state(pol.init(m), plan.pad))
    rounds = []
    for t in range(local.n_rounds):
        carry, out = _sharded_round(pol, plan, carry, local.round(t))
        rounds.append(out)
    looped = {k: plan.gather(torch.stack([o[k] for o in rounds], 1)).T
              for k in rounds[0]}
    res["graph_vs_loop"] = {k: bool(torch.equal(graphed[k], looped[k]))
                            for k in graphed}
    return res


def sharding_ranks(cases: dict) -> dict:
    """A rank of the sharding checks: ``shard_bandwidth_target`` on each
    rank's (draw, weight); ``solve_ccg_sharded`` at M = 64 and 13;
    ``repair_local`` of the max-fidelity solutions on this rank's slice."""
    mesh = host_mesh()
    d, rank = mesh.size(), shard_index(mesh)
    out = {"targets": []}
    for bw, w, budget in cases["targets"]:
        out["targets"].append(float(shard_bandwidth_target(
            torch.tensor(bw[rank]), torch.tensor(w[rank]), budget, mesh)))
    if "solve" in cases:
        prob = RobustProblem.build(SYS, "cpu")
        out["solve"] = {}
        for m, (z, aq) in cases["solve"].items():
            sol = solve_ccg_sharded(prob, torch.from_numpy(z),
                                    torch.from_numpy(aq), mesh)
            out["solve"][m] = to_numpy(sol)
    z, aq, sol, bw_scale = cases["repair"]
    ml = z.shape[0] // d
    sl = slice(rank * ml, (rank + 1) * ml)
    local = {k: torch.from_numpy(v[sl]) for k, v in sol.items()}
    pol = make_policy("r2evid", SYS, device="cpu",
                      rcfg=RouterConfig(repair_rounds=64))
    scale = torch.tensor(bw_scale)
    fixed = pol.repair_local(local, torch.from_numpy(z[sl]),
                             torch.from_numpy(aq[sl]), mesh=mesh,
                             bw_scale=scale)
    draw = pol.lat.solution_bandwidth(local).sum()
    target = shard_bandwidth_target(draw, torch.tensor(float(ml)),
                                    scale * SYS.total_bw_mbps, mesh)
    out["repair"] = {k: fixed[k].numpy() for k in DEC_KEYS}
    out["repair_target"] = float(target)
    return out


def elastic_ranks(stream_np: dict, plans: list) -> dict:
    """A rank of the elastic checks: the survivor meshes of
    ``elastic_remesh`` and ``run_elastic`` of τ-proxy r2evid under each
    failure plan (M = 64), with the mesh sizes of each run."""
    stream = obs_from_numpy(stream_np)
    m = stream.z.shape[1]
    res = {"meshes": {}}
    for n, prefer, min_model in ((4, "model", 1), (4, "data", 1),
                                 (3, "data", 1), (2, "model", 2),
                                 (4, "data", 2)):
        mesh = elastic_remesh(n, prefer=prefer, min_model=min_model)
        res["meshes"][n, prefer, min_model] = (
            tuple(mesh.mesh.shape), mesh.get_coordinate() is not None)
    res["runs"] = []
    for failures in plans:
        sess = ServeSession(policy("r2evid"), m, device="cpu")
        out = sess.run_elastic(stream, failures)
        res["runs"].append({
            "out": to_numpy(out), "state": state_leaves(sess.state),
            "sizes": [mesh.size() for _, mesh in sess.mesh_history]})
    return res
