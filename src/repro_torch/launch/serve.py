"""Serving launcher: R2E-VID routed inference over live edge/cloud pools —
port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --rounds 4 --streams 8

Video streams are synthesized (``data/video.py``), motion features
(``core/features.py``) drive the temporal gate, and one
:class:`~repro_torch.serving.session.ServeSession` owns the serving stack:
the gate-mode ``r2evid`` policy (its ``RouterState`` carry), the config
bundle, and the live tier pools the routed token workloads dispatch onto
(``session.dispatch``).

Each round consumes ``--segments-per-round`` segments per stream in one run
of the session's decide round (``session.route_many``, replayed as a CUDA
graph on the card): the gate recurrence carries across segments and
rounds, and the last segment's solution drives the round's dispatch.
``--policy`` swaps in any registered policy (baselines route the same loop;
they ignore the features).  ``--gate-resync`` sets the cadence at which the
batched gate recomputes its running volatility sums from the exact ring
buffer (0 = once per window; 1 = every step).  ``--device`` (default
``cuda``) names where everything runs; ``--device cpu`` runs the plain
versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.cost_model import SystemConfig
from repro_torch.core.features import feature_dim, segment_features
from repro_torch.core.gating import GateConfig, init_gate_params
from repro_torch.data.video import VideoConfig, generate_stream, make_task_batch
from repro_torch.device import resolve_device
from repro_torch.serving.policy import make_policy
from repro_torch.serving.pools import make_tier_pools
from repro_torch.serving.session import ServeSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--segments-per-round", type=int, default=8)
    ap.add_argument("--edge-arch", default="qwen1.5-0.5b")
    ap.add_argument("--cloud-arch", default="qwen3-8b")
    ap.add_argument("--policy", default="r2evid",
                    help="registered policy name (r2evid, a2_cloud_only, "
                         "jcab, rdap, sniper)")
    ap.add_argument("--gate-resync", type=int, default=0,
                    help="volatility resync cadence in steps (0 = per window)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sys_ = SystemConfig()
    if args.policy == "r2evid":
        gcfg = GateConfig(d_feature=feature_dim(),
                          resync_period=args.gate_resync)
        gparams = init_gate_params(gcfg, torch.Generator().manual_seed(0), dev)
        policy = make_policy("r2evid", sys_, device=dev, gate_cfg=gcfg,
                             gate_params=gparams)
    else:
        policy = make_policy(args.policy, sys_, device=dev)
    session = ServeSession(
        policy, n_streams=args.streams, device=dev,
        pools=make_tier_pools(get_smoke_config(args.edge_arch),
                              get_smoke_config(args.cloud_arch), device=dev),
    )

    spr = args.segments_per_round
    vcfg = VideoConfig()
    streams = [generate_stream(vcfg, n_segments=args.rounds * spr,
                               rng=np.random.default_rng(i))
               for i in range(args.streams)]
    aq = torch.as_tensor(make_task_batch(args.streams, "stable"), device=dev)
    # (streams, total_segments, d) segment features, all streams at once
    frames = torch.as_tensor(np.stack([fr for fr, _ in streams]), device=dev)
    dx_all = segment_features(frames, vcfg.frames_per_segment)

    for rnd in range(args.rounds):
        z = torch.as_tensor(
            np.array([m[rnd * spr:(rnd + 1) * spr].mean() for _, m in streams]),
            dtype=torch.float32, device=dev)
        t_route = time.perf_counter()
        # this round's segments through the session's decide round
        dx_seq = dx_all[:, rnd * spr:(rnd + 1) * spr].transpose(0, 1)
        sols = session.route_many(dx_seq.contiguous(), z, aq)
        sol = {k: v[-1] for k, v in sols.items()}
        route = sol["route"].cpu()            # waits for the round
        route_ms = (time.perf_counter() - t_route) * 1e3

        t0 = time.perf_counter()
        served = session.dispatch(sol)
        dt = time.perf_counter() - t0
        taus = sol.get("tau")
        print(f"round {rnd}: routes={route.tolist()} "
              + (f"taus={np.round(taus.cpu().numpy(), 2).tolist()} "
                 if taus is not None else "")
              + f"route={route_ms:.0f}ms serve={dt*1e3:.0f}ms")
        for tier, st in sorted(served.items()):
            if not st["requests"]:
                print(f"  tier{tier}: 0 req")
                continue
            print(f"  tier{tier}: {st['requests']} req "
                  f"{st['tokens_per_s']:.0f} tok/s "
                  f"p50={st['p50_s']*1e3:.0f}ms p99={st['p99_s']*1e3:.0f}ms")

    fb = session.feedback()
    print(f"feedback: bw_mult={np.round(np.asarray(fb['bw_mult']), 3).tolist()}"
          f" (apply_feedback folds this into the next round's observation)")
    for tier, pool in session.pools.items():
        s = pool.stats.summary()
        print(f"pool[{pool.name}]: requests={s['requests']} "
              f"tokens={s['tokens']} busy={s['busy_s']:.2f}s "
              f"throughput={s['tokens_per_s']:.0f} tok/s "
              f"p50={s['p50_s']*1e3:.0f}ms p99={s['p99_s']*1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
