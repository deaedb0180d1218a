"""Training across ranks in the port against the live JAX ``Trainer`` on
the same mesh shape, float32 SMOKE configs.

The JAX references run in one subprocess with 4 host devices, the mesh
built with Auto axes (``jax.make_mesh``'s default Explicit axes fail at
the embedding gather on this jax).  The subprocess writes the reference
initialisations first and the port's 4 gloo ranks (``run_ranks``, the
rank functions in ``torch_train_ranks.py``) start from them while it
trains.

* Qwen1.5-0.5B, Moonshot-v1-16B-A3B (dispatch groups and the global aux
  loss), Falcon-Mamba-7B and RecurrentGemma-9B at (data, model) = (4, 1)
  and (2, 2), 2 steps; Moonshot with ``grad_accum=2``; Qwen with
  ``grad_compression`` (whole-leaf absmax): each step's loss and gradient
  norm within 1e-5 relative; the state after step 1 as
  ``test_torch_trainer.py`` holds one step (parameters within 1e-6
  absolute, moments within 1e-5 of max(1e-3, the leaf's largest
  |entry|)), except parameters whose gradient is below 100 · eps, where
  Adam's first update amplifies summation order: their difference from
  the reference is the one both sides' moments imply
  (``_hold_first_step``);
  the moments after step 2 likewise (not with compression, whose int8
  codes may flip at a rounding edge); each rank's block of every leaf
  where JAX puts the shard of the device at its mesh position.
* ``compressed_allreduce`` on 4 ranks against the live JAX one under
  ``shard_map``: within 1e-6 of the result's largest |entry| (JAX sums
  the ranks by ``tensordot``, the port in rank order).
* A world of one at mesh (1, 1) is bit-equal to the one-device
  ``Trainer`` (bf16 and float32, accumulation and compression); the
  seeded ``init_state`` of 4 ranks assembles to the one-device draw.
* ``NodeFailure`` at step 3 on (2, 2) after the checkpoint at step 2; the
  survivors' world of 2 restores onto ``elastic_remesh(2)`` = (1, 2): the
  restored state bit-equal to the uninterrupted run's at step 2 (which
  the failed run's first two losses equal bit for bit: two runs of one
  world agree), steps 3-4 within 1e-5 relative of the uninterrupted run.
* The launcher trains across 2 gloo ranks.
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_train_ranks import (
    OPT,
    checkpoint_roundtrip,
    gathered_init,
    ordered_sum,
    smoke_f32,
    survivor_restart,
    world,
)

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_host_mesh, run_ranks, \
    single_rank_group
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamWConfig, lr_at
from repro_torch.train.trainer import TrainConfig, Trainer

FAMILIES = ("qwen1.5-0.5b", "moonshot-v1-16b-a3b", "falcon-mamba-7b",
            "recurrentgemma-9b")
SHAPES = ((4, 1), (2, 2))
CASES = [{"name": f"{a}@{d}x{m}", "arch": a, "shape": (d, m)}
         for a in FAMILIES for d, m in SHAPES] + [
    {"name": "moe_accum", "arch": "moonshot-v1-16b-a3b", "shape": (4, 1),
     "tcfg": {"grad_accum": 2}},
    {"name": "compression", "arch": "qwen1.5-0.5b", "shape": (2, 2),
     "tcfg": {"grad_compression": True}}]
STEPS = 2
TOL = 1e-5

JAX_SCRIPT = """
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.sharding.compat import shard_map
from repro.sharding.rules import make_rules
from repro.train.compression import compressed_allreduce
from repro.train.optimizer import AdamWConfig
from repro.train.trainer import TrainConfig, Trainer

with open(sys.argv[1], "rb") as f:
    args = pickle.load(f)
auto = lambda shape, names: jax.make_mesh(
    shape, names, axis_types=(AxisType.Auto,) * len(shape))
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)


def path(kp):
    return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in kp)


def trainer(case, mesh):
    cfg = dataclasses.replace(get_smoke_config(case["arch"]),
                              compute_dtype="float32")
    rules = make_rules(mesh, "train", cfg.sharding_overrides.get("train"))
    return Trainer(cfg, TrainConfig(steps=2, ckpt_dir=args["tmp"],
                                    opt=AdamWConfig(**args["opt"]),
                                    **case.get("tcfg", {})),
                   mesh=mesh, rules=rules)


inits = {}
for arch in args["inits"]:
    mesh = auto((4, 1), ("data", "model"))
    with mesh:
        params, _, _ = trainer({"arch": arch}, mesh).init_state(
            jax.random.PRNGKey(9))
    inits[arch] = tonp(params)
if inits:
    with open(sys.argv[2] + ".tmp", "wb") as f:
        pickle.dump(inits, f)
    os.replace(sys.argv[2] + ".tmp", sys.argv[2])

out = {"cases": {}}
for case in args["cases"]:
    mesh = auto(case["shape"], ("data", "model"))
    tr = trainer(case, mesh)
    rec = {"loss": [], "grad_norm": [], "whole": []}
    with mesh:
        state = tr.init_state(jax.random.PRNGKey(9))
        blocks = {}
        for kp, leaf in jax.tree_util.tree_flatten_with_path(state[0])[0]:
            idx = leaf.sharding.devices_indices_map(leaf.shape)
            blocks[path(kp)] = [
                [(s.start or 0, (s.stop if s.stop is not None else n)
                  - (s.start or 0)) for s, n in zip(idx[dev], leaf.shape)]
                for dev in mesh.devices.reshape(-1)]
        rec["blocks"] = blocks
        for b in args["batches"][case["arch"]]:
            params, opt, err, m = tr._step_fn(
                *state, {k: jnp.asarray(v) for k, v in b.items()})
            state = (params, opt, err)
            rec["loss"].append(float(m["loss"]))
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["whole"].append({"params": tonp(params),
                                 "mu": tonp(opt.mu), "nu": tonp(opt.nu)})
    out["cases"][case["name"]] = rec

if args["allreduce"] is not None:
    mesh = auto((4,), ("data",))
    car = shard_map(lambda g: compressed_allreduce(g, "data"), mesh=mesh,
                    in_specs=P("data"), out_specs=P(), check_vma=False)
    out["allreduce"] = np.asarray(jax.jit(car)(jnp.asarray(
        args["allreduce"])))
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


def _batches(arch, n=STEPS, seed=3):
    cfg = get_smoke_config(arch)
    it = iter(TokenPipeline(cfg.vocab_size, 32, 8, seed=seed))
    return [next(it) for _ in range(n)]


# the cases of the two JAX subprocesses, about equal in compile time
SPLIT = ({"qwen1.5-0.5b@4x1", "qwen1.5-0.5b@2x2", "moonshot-v1-16b-a3b@4x1",
          "moonshot-v1-16b-a3b@2x2", "moe_accum", "compression"},)


def _jax_procs(tmp, batches, g) -> list:
    """Start the JAX references: two subprocesses, the first also writing
    the initialisations (``init.pkl``) and the second the all-reduce."""
    procs = []
    for i, first in enumerate((True, False)):
        cases = [c for c in CASES if (c["name"] in SPLIT[0]) == first]
        args = {"cases": cases, "opt": OPT, "tmp": str(tmp / f"j{i}"),
                "inits": FAMILIES if first else (),
                "allreduce": None if first else g,
                "batches": {a: b[:STEPS] for a, b in batches.items()}}
        with open(tmp / f"args{i}.pkl", "wb") as f:
            pickle.dump(args, f)
        procs.append((subprocess.Popen(
            [sys.executable, "-c", torch_threads.child_script(JAX_SCRIPT),
             str(tmp / f"args{i}.pkl"), str(tmp / "init.pkl"),
             str(tmp / f"ref{i}.pkl")],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=torch_threads.subprocess_env(i, JAX_PLATFORMS="cpu")),
            tmp / f"ref{i}.pkl"))
    return procs


def _wait_for(path, proc, timeout=300.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise AssertionError(proc.stderr.read()[-3000:])
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {timeout} s")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the port's 4-rank world and its survivors'
    world of 2, on the same numpy inputs."""
    tmp = tmp_path_factory.mktemp("train_ranks")
    rng = np.random.default_rng(7)
    g = (rng.standard_normal((4, 1000)) * rng.uniform(0.1, 3.0, (4, 1))
         ).astype(np.float32)
    batches = {a: _batches(a, 4 if a == "qwen1.5-0.5b" else STEPS)
               for a in FAMILIES}
    procs = _jax_procs(tmp, batches, g)
    ref = {"cases": {}}
    try:
        _wait_for(tmp / "init.pkl", procs[0][0])
        with open(tmp / "init.pkl", "rb") as f:
            inits = pickle.load(f)
        port = run_ranks(world, 4, backend="gloo", timeout=300,
                         args=(inits, batches, CASES, g, str(tmp / "t")))
        survivors = run_ranks(
            survivor_restart, 2, backend="gloo", timeout=120,
            args=(inits["qwen1.5-0.5b"], batches["qwen1.5-0.5b"],
                  str(tmp / "t"), 2))
        for proc, path in procs:
            _, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, err[-3000:]
            with open(path, "rb") as f:
                part = pickle.load(f)
            ref["cases"].update(part.pop("cases"))
            ref.update(part)
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return {"ref": ref, "port": port,
            "failure": [r["failure"] for r in port],
            "survivors": survivors, "g": g}


def _rel(a, b):
    return abs(a - b) / abs(b)


def _hold_moments(got, ref):
    """Each moment within 1e-5 of max(1e-3, the leaf's largest |entry|)."""

    def moment(a, b):
        scale = max(1e-3, float(np.abs(b).max()))
        assert float(np.abs(a - b).max()) <= 1e-5 * scale

    tree_map(moment, got["mu"], ref["mu"])
    tree_map(moment, got["nu"], ref["nu"])


def _hold_first_step(got, ref):
    """The state after step 1 as ``test_torch_trainer.py`` holds one step
    (parameters within 1e-6, moments as :func:`_hold_moments`), but for
    the elements whose gradient |g| = sqrt(v / (1 - b2)) is below
    100 · eps: there Adam's first update lr · g / (|g| + eps) turns the
    last digits of a gradient summed over ranks in another order into
    update differences of up to lr (seen: 2e-5 at |g| ~ 1e-9).  There the
    parameters' difference is held, within 1e-6, to the one the two
    sides' own moments imply, -lr · (u_port - u_ref) with u = mhat /
    (sqrt(vhat) + eps): each side's update of those elements is the one
    its moments give."""
    opt = AdamWConfig(**OPT)
    lr = float(lr_at(opt, 1))

    def u(mu, nu):
        mhat = mu.astype(np.float64) / (1 - opt.b1)
        vhat = nu.astype(np.float64) / (1 - opt.b2)
        return mhat / (np.sqrt(vhat) + opt.eps)

    def params(a, b, mu_a, nu_a, mu_b, nu_b):
        steep = np.sqrt(nu_b / (1 - opt.b2)) < 100 * opt.eps
        np.testing.assert_allclose(a[~steep], b[~steep], rtol=0, atol=1e-6)
        implied = -lr * (u(mu_a, nu_a) - u(mu_b, nu_b))
        np.testing.assert_allclose((a.astype(np.float64) - b)[steep],
                                   implied[steep], rtol=0, atol=1e-6)

    tree_map(params, got["params"], ref["params"], got["mu"], got["nu"],
             ref["mu"], ref["nu"])
    _hold_moments(got, ref)


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_training_matches_the_live_jax_trainer(runs, case):
    want = runs["ref"]["cases"][case]
    ranks = [r["cases"][case] for r in runs["port"]]
    for k in ("loss", "grad_norm"):
        for step in range(STEPS):
            got = [r[k][step] for r in ranks]
            assert len(set(got)) == 1, (k, got)     # every rank's the same
            assert _rel(got[0], want[k][step]) <= TOL, (k, step, got[0],
                                                        want[k][step])
    _hold_first_step(ranks[0]["whole"][0], want["whole"][0])
    if case != "compression":   # int8 codes may flip at a rounding edge
        _hold_moments(ranks[0]["whole"][1], want["whole"][1])


@pytest.mark.parametrize("case", [c["name"] for c in CASES
                                  if c.get("tcfg") is None])
def test_each_rank_holds_the_block_jax_places_on_its_device(runs, case):
    want = runs["ref"]["cases"][case]["blocks"]
    for rank, r in enumerate(runs["port"]):
        got = r["cases"][case]["blocks"]
        assert sorted(got) == sorted(want)
        for path, (start, shape) in got.items():
            assert [(s, n) for s, n in zip(start, shape)] == \
                [tuple(x) for x in want[path][rank]], (path, rank)


def test_compressed_allreduce_matches_the_live_jax_one(runs):
    want = runs["ref"]["allreduce"]
    outs = [r["allreduce"] for r in runs["port"]]
    for o in outs:
        np.testing.assert_array_equal(o, outs[0])
    assert outs[0].shape == (1000,) and want.shape == (1, 1000)
    scale = float(np.abs(want).max())
    assert float(np.abs(outs[0] - want[0]).max()) <= 1e-6 * scale
    # each rank's codes and scale, summed in rank order
    g = runs["g"]
    total = None
    for row in g:
        s = np.float32(max(np.abs(row).max(), 1e-12) / np.float32(127.0))
        q = np.clip(np.round(row / s), -127, 127).astype(np.int8)
        part = s * q.astype(np.float32)
        total = part if total is None else total + part
    np.testing.assert_array_equal(outs[0], total)


def test_survivors_resume_the_checkpoint_on_their_mesh(runs):
    fail = runs["failure"]
    assert all(r["failed"] == "step 3: node lost" for r in fail)
    assert {r["failed_step"] for r in fail} == {3}
    assert {r["ckpt_step"] for r in fail} == {2}
    full = fail[0]["losses"]
    assert all(r["losses"] == full for r in fail)
    surv = runs["survivors"]
    for r in surv:
        assert r["shape"] == (1, 2) and r["step"] == 2
        assert r["steps"] == [3, 4]
        for got, want in zip(tree_leaves(r["restored"]),
                             tree_leaves(fail[0]["at2"])):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(r["losses"], full[2:]):
            assert _rel(got, want) <= TOL, (got, want)
    # the failed run and the survivors agree on every loss they share
    port = runs["port"][0]["cases"]["qwen1.5-0.5b@2x2"]["loss"]
    assert port == full[:STEPS]


def _one_device(cfg, tmp, **kw):
    return Trainer(cfg, TrainConfig(steps=3, ckpt_dir=str(tmp),
                                    opt=AdamWConfig(**OPT), **kw),
                   device="cpu")


@pytest.mark.parametrize("arch,dtype,kw", [
    ("qwen1.5-0.5b", "bfloat16", {"grad_accum": 2,
                                  "grad_compression": True}),
    ("moonshot-v1-16b-a3b", "float32", {"grad_accum": 2}),
    ("falcon-mamba-7b", "bfloat16", {})])
def test_world_of_one_is_bit_equal_to_one_device(tmp_path, arch, dtype, kw):
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=dtype)
    batches = _batches(arch, 3)
    one = _one_device(cfg, tmp_path / "one", **kw)
    state = one.init_state(torch.Generator().manual_seed(4))
    want = []
    for b in batches:
        *state, m = one._step(*state, one._device_batch(b))
        want.append(m)
    with single_rank_group("gloo"):
        mesh = make_host_mesh((1, 1))
        tr = Trainer(cfg, TrainConfig(steps=3, ckpt_dir=str(tmp_path / "w"),
                                      opt=AdamWConfig(**OPT), **kw),
                     mesh=mesh, device="cpu")
        got_state = tr.init_state(torch.Generator().manual_seed(4))
        for b, w in zip(batches, want):
            *got_state, m = tr._step(*got_state, tr._device_batch(b))
            for k in ("loss", "grad_norm"):
                assert torch.equal(m[k], w[k]), k
    leaves = lambda s: tree_leaves(s[0]) + tree_leaves(s[1].mu) + \
        tree_leaves(s[1].nu) + (tree_leaves(s[2]) if s[2] else [])
    for a, b in zip(leaves(got_state), leaves(state)):
        assert torch.equal(a, b)


def test_seeded_init_assembles_to_the_one_device_draw(tmp_path):
    cfg = smoke_f32("moonshot-v1-16b-a3b")
    want = _one_device(cfg, tmp_path).init_state(
        torch.Generator().manual_seed(11))[0]
    got = run_ranks(gathered_init, 4, backend="gloo", timeout=120,
                    args=("moonshot-v1-16b-a3b", (2, 2), 11,
                          str(tmp_path / "r")))
    for r in got:
        for a, b in zip(tree_leaves(r), tree_leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())


def test_psum_ordered_adds_the_ranks_in_rank_order(tmp_path):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 257))
         * 1e4 ** rng.integers(-1, 2, (4, 257))).astype(np.float32)
    x[:, 0] = [1e8, 1.0, -1e8, 1.0]     # 1 in rank order; 2 or 0 otherwise
    want = ((x[0] + x[1]) + x[2]) + x[3]
    got = run_ranks(ordered_sum, 4, backend="gloo", timeout=120, args=(x,))
    assert want[0] == 1.0
    for g in got:
        np.testing.assert_array_equal(g, want)


def test_sharded_checkpoint_roundtrip_on_two_gloo_ranks(tmp_path):
    got = run_ranks(checkpoint_roundtrip, 2, backend="gloo", timeout=180,
                    args=("cpu", str(tmp_path / "ckpt")))
    for r in got:
        assert r == {"same": True, "step": 1,
                     "ranks": ["rank_0", "rank_1"]}


def test_trainer_refuses_an_unsupported_mesh_or_split(tmp_path):
    cfg = smoke_f32("qwen1.5-0.5b")
    tcfg = TrainConfig(ckpt_dir=str(tmp_path), grad_accum=3)
    with pytest.raises(ValueError, match="need a mesh"):
        Trainer(cfg, tcfg, rules=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, tcfg, mesh=object(), device="cpu")
    with single_rank_group("gloo"):
        from torch.distributed.device_mesh import DeviceMesh
        with pytest.raises(ValueError, match="dims"):
            Trainer(cfg, tcfg, mesh=DeviceMesh("cpu", [0],
                                               mesh_dim_names=("data",)),
                    device="cpu")
        tr = Trainer(cfg, tcfg, mesh=make_host_mesh((1, 1)), device="cpu")
        with pytest.raises(ValueError, match="does not split"):
            tr._device_batch(_batches("qwen1.5-0.5b", 1)[0])


def test_launcher_trains_across_two_gloo_ranks(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    assert train_launcher.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
        "--seq", "32", "--ckpt-every", "2", "--ckpt-dir", str(ckpt),
        "--mesh", "host", "--ranks", "2", "--backend", "gloo",
        "--mesh-shape", "2,1"]) == 0
    out = capsys.readouterr().out
    assert "done: 2 steps, arch=qwen1.5-0.5b-smoke, ranks=2 backend=gloo " \
           "mesh=(2, 1)" in out
    assert sorted(p.name for p in (ckpt / "step_2").iterdir()) == [
        "manifest.json", "rank_0.bin", "rank_0.json", "rank_1.bin",
        "rank_1.json"]
    with pytest.raises(NotImplementedError, match="A.17"):
        train_launcher.main(["--smoke", "--device", "cpu", "--mesh",
                             "single"])
    with pytest.raises(SystemExit):     # --ranks without --mesh host
        train_launcher.main(["--smoke", "--device", "cpu", "--ranks", "2"])

