"""What each rank of the tensor-parallel training test runs (spawned by
``repro_torch.launch.mesh.run_ranks``, so importable and free of JAX):
the port's ``Trainer`` split over the mesh's ``"model"`` dim, the
autograd collectives of ``sharding/tensor_parallel.py``, the
vocab-parallel cross-entropy and a checkpoint moved between meshes,
returning numpy results for the test process to hold."""
from __future__ import annotations
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)

import dataclasses

import numpy as np
import torch
from torch_train_ranks import OPT, run_steps, smoke_f32, state_from_numpy, \
    trainer

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import Ctx
from repro_torch.models.model import chunked_ce_loss, loss_fn
from repro_torch.models.params import GATHERED
from repro_torch.sharding import tensor_parallel as tp
from repro_torch.sharding.rules import make_rules
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def variant(arch: str, kw: dict):
    """The float32 SMOKE config of ``arch`` with ``kw`` replaced;
    ``"overrides"`` takes the full config's ``sharding_overrides``."""
    kw = dict(kw)
    if kw.pop("overrides", False):
        kw["sharding_overrides"] = get_config(arch).sharding_overrides
    return dataclasses.replace(smoke_f32(arch), **kw)


def train_case(case: dict, params_np, batches, tmp: str) -> dict:
    """``case`` on a host mesh of its shape from the numpy parameters
    (None: the seeded init): losses, gradient norms, the modes the layers
    ran, the most units with a gathered copy alive at once and the
    gathers made; rank 0 also the whole state after each step."""
    mesh = make_host_mesh(case["shape"])
    tr = trainer(variant(case["arch"], case.get("cfg", {})), mesh,
                 f"{tmp}/{case['name']}")
    state = state_from_numpy(tr, params_np) if params_np is not None else \
        tr.init_state(torch.Generator().manual_seed(4))
    tp.MODES.clear()
    GATHERED.reset()
    wholes = []
    _, losses, norms = run_steps(tr, state, batches, wholes)
    out = {"loss": losses, "grad_norm": norms, "modes": dict(tp.MODES),
           "peak_units": GATHERED.peak, "gathers": GATHERED.gathers}
    if torch.distributed.get_rank() == 0:
        out["whole"] = wholes
    return out


class ViewGradTap:
    """A reducer that keeps each view's gradient as the backward hands it
    over (no sum over ranks), by the block it views."""

    def __init__(self):
        self.anchor = torch.zeros((), requires_grad=True)
        self.got = {}

    def expect(self, leaf, tag):
        pass

    def deliver(self, leaf, g):
        key = leaf.block.data_ptr()
        self.got[key] = g if key not in self.got else self.got[key] + g


def view_grads(arch: str, params_np, batch, shape, names, tmp: str) -> dict:
    """The rank's gradients of its compute views (before any sum over
    ranks) of the leaves at ``names`` (paths of keys; each a stacked leaf,
    its layers' gradients stacked)."""
    tr = trainer(smoke_f32(arch), make_host_mesh(shape), f"{tmp}/grads")
    params = state_from_numpy(tr, params_np)[0]
    tap = ViewGradTap()
    leaves = tr.mesh_leaves(params, tap, None)
    loss, _ = loss_fn(tr.ctx, leaves, tr._device_batch(batch))
    loss.backward()

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    return {"/".join(map(str, p)): torch.stack([
        tap.got[b.data_ptr()] for b in at(params, p).unbind(0)]).numpy()
        for p in names}


def world(inits: dict, batches: dict, cases, grad_case, tmp: str) -> dict:
    """The 4-rank world: every training case, then the view gradients of
    ``grad_case`` = (arch, shape, leaf paths)."""
    out = {"cases": {c["name"]: train_case(
        c, inits.get(c["arch"]) if c.get("from_inits", True) else None,
        batches[c["arch"]], tmp) for c in cases}}
    arch, shape, names = grad_case
    out["view_grads"] = view_grads(arch, inits[arch], batches[arch][0],
                                   shape, names, tmp)
    return out


# ---------------------------------------------------------------------------
# two ranks: the collectives, the cross-entropy, a checkpoint across meshes
# ---------------------------------------------------------------------------
def collectives(x_np, g_np, parts_np) -> dict:
    """Each autograd collective over the ``"model"`` dim of a (1, 2) mesh,
    forward and backward: ``x_np`` a whole tensor, ``parts_np[r]`` rank
    r's part and ``g_np[r]`` the gradient that rank r's loss puts on the
    output (the loss sum(out * g))."""
    mesh = make_host_mesh((1, 2))
    r = tp.rank(mesh)
    g = torch.from_numpy(g_np[r])
    out = {}
    cases = {"copy": (x_np, lambda t: tp.copy_to_model(t, mesh)),
             "reduce": (parts_np[r], lambda t: tp.reduce_from_model(t, mesh)),
             "gather": (parts_np[r],
                        lambda t: tp.gather_from_model(t, mesh, dim=1)),
             "scatter": (x_np, lambda t: tp.scatter_to_model(t, mesh, dim=1))}
    for name, (inp, fn) in cases.items():
        t = torch.from_numpy(np.array(inp)).requires_grad_(True)
        y = fn(t)
        gy = g if y.shape == g.shape else g[:, :y.shape[1]]
        (grad,) = torch.autograd.grad((y * gy).sum(), t)
        out[name] = (y.detach().numpy(), grad.numpy())
    return out


def vocab_ce(x_np, w_np, labels_np, mask_np) -> dict:
    """``chunked_ce_loss`` over the ``"model"`` dim of a (1, 2) mesh (this
    rank's half of the head's vocab columns) and on the whole head in
    this process: the losses and the gradients of x and of this rank's
    columns."""
    arch = "qwen1.5-0.5b"
    cfg = dataclasses.replace(smoke_f32(arch), vocab_size=w_np.shape[1],
                              loss_chunk=8)
    mesh = make_host_mesh((1, 2))
    ctx = Ctx(cfg=cfg, mesh=mesh, rules=make_rules(mesh, "train"))
    n = w_np.shape[1] // 2
    cols = slice(tp.rank(mesh) * n, (tp.rank(mesh) + 1) * n)
    labels, mask = torch.from_numpy(labels_np), torch.from_numpy(mask_np)

    def ce(ctx_, w_np_):
        x = torch.from_numpy(x_np).requires_grad_(True)
        w = torch.from_numpy(np.ascontiguousarray(w_np_)).requires_grad_(True)
        loss = chunked_ce_loss(ctx_, x, w, labels, mask)
        gx, gw = torch.autograd.grad(loss, (x, w))
        return {"loss": loss.item(), "gx": gx.numpy(), "gw": gw.numpy()}

    got, want = ce(ctx, w_np[:, cols]), ce(Ctx(cfg=cfg), w_np)
    want["gw"] = want["gw"][:, cols]
    return {"got": got, "want": want}


def checkpoint_across_meshes(params_np, batches, tmp: str) -> dict:
    """Qwen1.5-0.5B SMOKE trained 2 steps at (1, 2), its state saved after
    step 1; then restored onto (2, 1) in the same world and step 2 run
    there -> both meshes' step-2 losses, the restored step."""
    cfg = smoke_f32("qwen1.5-0.5b")

    def make(shape):
        return Trainer(cfg, TrainConfig(steps=2, ckpt_every=100, log_every=1,
                                        ckpt_dir=f"{tmp}/ckpt",
                                        opt=AdamWConfig(**OPT)),
                       mesh=make_host_mesh(shape), device="cpu")

    tr = make((1, 2))
    state = state_from_numpy(tr, params_np)
    state, hist = tr.run(iter(batches), n_steps=1, state=state)
    tr.save(state)
    state, hist2 = tr.run(iter(batches[1:]), n_steps=1, state=state)
    back = make((2, 1))
    restored = back.maybe_restore(back.init_state(
        torch.Generator().manual_seed(1)))
    step = back.step
    _, hist3 = back.run(iter(batches[1:]), n_steps=1, state=restored)
    return {"restored_step": step, "tp_losses": [hist[-1]["loss"],
                                                 hist2[-1]["loss"]],
            "restored_loss": hist3[-1]["loss"]}


def two_ranks(coll_args, ce_args, params_np, batches, registry,
              tmp: str) -> dict:
    """The 2-rank world: the collectives, the cross-entropy, the
    checkpoint, then every config of ``registry`` ({arch: batches}) split
    at (1, 2) from the seeded init."""
    return {"collectives": collectives(*coll_args),
            "ce": vocab_ce(*ce_args),
            "ckpt": checkpoint_across_meshes(params_np, batches, tmp),
            "registry": {arch: train_case(
                {"name": arch, "arch": arch, "shape": (1, 2)}, None, b, tmp)
                for arch, b in registry.items()}}

