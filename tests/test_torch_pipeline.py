"""The port's GPipe pipeline (``sharding/pipeline.py``) against the live JAX
``repro.sharding.pipeline``: 4 stages of 2 tanh layers at width 16, 8
microbatches of 4 rows, on 4 gloo ranks (``run_ranks``; the rank function
in ``torch_train_ranks.py``) against the sequential loop and against the
JAX pipeline on 4 host devices (one subprocess, a mesh with an Auto
``"stage"`` axis), each within 1e-5; ``split_stages`` and
``bubble_fraction`` against the reference's."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_train_ranks import layer, pipeline_rank

from repro.sharding.pipeline import bubble_fraction as j_bubble_fraction
from repro.sharding.pipeline import split_stages as j_split_stages
from repro_torch.launch.mesh import run_ranks
from repro_torch.sharding.pipeline import bubble_fraction, split_stages

S, LPS, D, M, B = 4, 2, 16, 8, 4     # stages, layers a stage, width,
L = S * LPS                          # microbatches, microbatch rows

JAX_SCRIPT = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.sharding.pipeline import pipeline, split_stages

with open(sys.argv[1], "rb") as f:
    w, b, xs = pickle.load(f)


def stage_fn(params, x):
    def body(x, wb):
        return jnp.tanh(x @ wb[0] + wb[1]), None
    return jax.lax.scan(body, x, params)[0]


mesh = jax.make_mesh((4,), ("stage",), axis_types=(AxisType.Auto,))
fn = pipeline(stage_fn, mesh, axis="stage")
out = jax.jit(fn)(split_stages((jnp.asarray(w), jnp.asarray(b)), 4),
                  jnp.asarray(xs))
with open(sys.argv[2], "wb") as f:
    pickle.dump(np.asarray(out), f)
"""


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((L, D, D)) * D ** -0.5).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return w, b, xs


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT),
         str(tmp / "in.pkl"), str(tmp / "out.pkl")],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        port = run_ranks(pipeline_rank, S, backend="gloo", timeout=120,
                         args=(*inputs, S))
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return port, pickle.load(f)


def _sequential(w, b, xs):
    x = torch.from_numpy(xs)
    for i in range(L):
        x = layer(torch.from_numpy(w[i]), torch.from_numpy(b[i]), x)
    return x.numpy()


def test_pipeline_matches_the_sequential_loop_on_every_stage(inputs, runs):
    port, _ = runs
    want = _sequential(*inputs)
    for out in port:
        assert out.shape == (M, B, D)
        np.testing.assert_array_equal(out, port[-1])
        assert float(np.abs(out - want).max()) < 1e-5


def test_pipeline_matches_the_live_jax_pipeline(runs):
    port, jax_out = runs
    assert jax_out.shape == (M, B, D)
    assert float(np.abs(port[0] - jax_out).max()) < 1e-5


def test_split_stages_matches_the_reference(inputs):
    w, b, _ = inputs
    got = split_stages([torch.from_numpy(w), torch.from_numpy(b)], S)
    want = j_split_stages((jnp.asarray(w), jnp.asarray(b)), S)
    for g, j in zip(got, want):
        assert tuple(g.shape) == (S, LPS) + tuple(j.shape[2:])
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="do not split"):
        split_stages(torch.zeros(6, 2), 4)


@pytest.mark.parametrize("m,s", [(8, 4), (1, 1), (1, 4), (32, 2), (5, 3)])
def test_bubble_fraction_matches_the_reference(m, s):
    assert bubble_fraction(m, s) == j_bubble_fraction(m, s)
