"""The port's training loss and its gradient against the live JAX package.

* ``loss_fn`` (total, ce and the MoE aux loss) and the gradient of every
  parameter leaf against ``jax.value_and_grad`` of the reference's
  ``loss_fn`` on the same weights (the reference's ``init_params``, norm
  scales and biases perturbed, converted with ``model_params_from_numpy``)
  and the same ``TokenPipeline`` batch, for every SMOKE config of the
  registry: dense MHA and GQA, MoE (the aux loss through ``aux_weight``
  0.5), M-RoPE and embedding inputs, Mamba and RG-LRU blocks (the plain
  scans on the CPU) and a window shorter than the sequence.  Float32
  compute on both sides: the loss within 1e-5 relative, each gradient
  within 2e-5 of max(1e-3, the leaf's largest |entry|) (sums in another
  order: measured below 2e-6).
* Remat on and off give the same gradient, bit for bit (the CPU recomputes
  the same operations in the same order).
"""
import torch_threads  # noqa: F401  (first: caps this process's CPU threads)
import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's kernels import cycle)
import jax
import jax.numpy as jnp
from repro.configs import get_smoke_config as j_smoke
from repro.models import Ctx as JCtx
from repro.models import loss_fn as j_loss_fn
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import model_params_from_numpy, tree_to_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.layers import Ctx
from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_leaves, tree_map
from test_torch_model import _weights

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5        # of max(GRAD_FLOOR, the leaf's largest |entry|)
GRAD_FLOOR = 1e-3
AUX_WEIGHT = 0.5


def _setup(arch, seq=48, batch=2, seed=1):
    jcfg = dataclasses.replace(j_smoke(arch), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jp = _weights(jcfg)
    data = TokenPipeline(cfg.vocab_size, seq, batch, seed=seed,
                         d_model=cfg.d_model, embed_inputs=cfg.embed_inputs,
                         mrope=cfg.mrope)
    return jcfg, cfg, jp, next(data)


def _port_value_and_grad(cfg, params, batch, **ctx_kw):
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(Ctx(cfg=cfg, mode="train", **ctx_kw), leaves,
                            {k: torch.from_numpy(v) for k, v in batch.items()},
                            aux_weight=AUX_WEIGHT)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_and_gradient_match_the_reference(arch):
    jcfg, cfg, jp, batch = _setup(arch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(JCtx(cfg=jcfg), p, jbatch, AUX_WEIGHT),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, jp))
    loss, metrics, grads = _port_value_and_grad(
        cfg, model_params_from_numpy(jp, cfg, "cpu"), batch)

    for got, want in ((loss, jloss), (metrics["ce"], jm["ce"]),
                      (metrics["aux"], jm["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_RTOL, atol=1e-7)
    if cfg.moe is not None:
        assert float(jm["aux"]) > 0.5      # the aux loss is in the total
    worst = []

    def check(got, want):
        want = np.asarray(want, np.float32)
        scale = max(GRAD_FLOOR, float(np.abs(want).max()))
        err = float(np.abs(got - want).max()) / scale
        worst.append(err)
        assert err <= GRAD_TOL, (arch, err)

    tree_map(check, tree_to_numpy(grads),
             jax.tree_util.tree_map(np.asarray, jgrads))
    assert len(worst) == len(tree_leaves(grads))


@pytest.mark.parametrize("arch", ["qwen3-8b", "recurrentgemma-9b",
                                  "mixtral-8x22b"])
def test_remat_gives_the_same_gradient(arch):
    _, cfg, jp, batch = _setup(arch)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = _port_value_and_grad(
            c, model_params_from_numpy(jp, c, "cpu"), batch)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)
