"""The gate's front end and the serve launcher of the port against the
live JAX package: ``data/video.py`` (numpy in both: equal exactly),
``core/features.py`` (torch against jnp: within 1e-6 absolute, the two
frameworks' means and the population std summing in their own orders),
and ``python -m repro_torch.launch.serve`` run on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.data import video as jvideo
from repro_torch.core import features as tfeat
from repro_torch.data import video as tvideo
from repro_torch.launch import serve

FEAT_ATOL = 1e-6


@pytest.mark.parametrize("profile", [None, "fixed"])
@pytest.mark.parametrize("cfg", [{}, {"height": 48, "width": 40,
                                      "n_blobs": 3, "frames_per_segment": 4,
                                      "seed": 5}])
def test_generate_stream_equals_reference(cfg, profile):
    motion = None if profile is None else np.linspace(0.05, 0.95, 5)
    want = jvideo.generate_stream(jvideo.VideoConfig(**cfg), 5,
                                  motion_profile=motion)
    got = tvideo.generate_stream(tvideo.VideoConfig(**cfg), 5,
                                 motion_profile=motion)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # a given generator is consumed alike
    want = jvideo.generate_stream(jvideo.VideoConfig(**cfg), 3,
                                  rng=np.random.default_rng(7))
    got = tvideo.generate_stream(tvideo.VideoConfig(**cfg), 3,
                                 rng=np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("req", ["stable", "fluctuating"])
def test_make_task_batch_equals_reference(req):
    got = tvideo.make_task_batch(37, req, seed=3)
    want = jvideo.make_task_batch(37, req, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _frames(seed, shape=(17, 64, 64)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(17, 64, 64), (9, 32, 32), (5, 30, 26)])
def test_motion_features_match_reference(shape):
    """φ of every frame pair and the moving average of window 3; the
    single-pair ``frame_diff_features`` too."""
    frames = _frames(len(shape) + shape[1], shape)
    want = jfeat.motion_features(jnp.asarray(frames))
    got = tfeat.motion_features(torch.from_numpy(frames))
    assert tuple(got.shape) == (shape[0] - 1, tfeat.feature_dim()) \
        == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FEAT_ATOL)
    one = tfeat.frame_diff_features(torch.from_numpy(frames[0]),
                                    torch.from_numpy(frames[1]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jfeat.frame_diff_features(
            jnp.asarray(frames[0]), jnp.asarray(frames[1]))),
        rtol=0, atol=FEAT_ATOL)


@pytest.mark.parametrize("segment_len", [4, 8])
def test_segment_features_match_reference(segment_len):
    """On generated video (the launcher's input), one stream and a batch of
    three streams at once (the port batches over leading axes)."""
    vcfg = tvideo.VideoConfig()
    streams = [tvideo.generate_stream(vcfg, 3, rng=np.random.default_rng(i))
               [0] for i in range(3)]
    batch = tfeat.segment_features(torch.from_numpy(np.stack(streams)),
                                   segment_len)
    assert tuple(batch.shape) == (3, 24 // segment_len, tfeat.feature_dim())
    for i, frames in enumerate(streams):
        want = np.asarray(jfeat.segment_features(jnp.asarray(frames),
                                                 segment_len))
        got = tfeat.segment_features(torch.from_numpy(frames), segment_len)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FEAT_ATOL)
        np.testing.assert_allclose(batch[i].numpy(), want, rtol=0,
                                   atol=FEAT_ATOL)


def test_feature_dim_is_reexported_by_the_gate():
    from repro_torch.core import feature_dim
    from repro_torch.core.gating import feature_dim as gate_feature_dim

    assert feature_dim() == gate_feature_dim() == jfeat.feature_dim() == 35


@pytest.mark.parametrize("policy", ["r2evid", "jcab"])
def test_serve_launcher_runs_on_the_cpu(policy, capsys):
    """``main`` at ``--rounds 1 --streams 4 --segments-per-round 2 --device
    cpu``: one round's routes and τ, the served tiers, the feedback and
    both pools' summaries, as the reference prints them."""
    assert serve.main(["--rounds", "1", "--streams", "4",
                       "--segments-per-round", "2", "--device", "cpu",
                       "--policy", policy]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("round 0: routes=[")
    assert ("taus=[" in out[0]) == (policy == "r2evid")
    routes = eval(out[0].split("routes=")[1].split("]")[0] + "]")
    assert len(routes) == 4 and set(routes) <= {0, 1}
    assert any(line.startswith("feedback: bw_mult=") for line in out)
    pools = [line for line in out if line.startswith("pool[")]
    assert [p.split("]")[0] for p in pools] == ["pool[edge", "pool[cloud"]
    served = sum(int(p.split("requests=")[1].split()[0]) for p in pools)
    assert served == 4


@pytest.mark.parametrize("cloud", ["moonshot-v1-16b-a3b", "mixtral-8x22b"])
def test_serve_launcher_runs_a_moe_cloud_tier(cloud, capsys):
    """``--cloud-arch`` of a MoE model (its SMOKE config, as the
    reference's launcher builds it): the cloud pool routes its segments
    through the experts and reports its summary."""
    assert serve.main(["--rounds", "1", "--streams", "6",
                       "--segments-per-round", "2", "--device", "cpu",
                       "--policy", "A2", "--cloud-arch", cloud]) == 0
    out = capsys.readouterr().out.splitlines()
    cloud_pool = [line for line in out if line.startswith("pool[cloud]")]
    assert len(cloud_pool) == 1
    assert int(cloud_pool[0].split("requests=")[1].split()[0]) == 6
