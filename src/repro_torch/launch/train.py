"""Training launcher: port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 200 --batch 8 --seq 128 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 4 \
      --mesh host --ranks 2 --backend gloo --device cpu [--mesh-shape 2,1]

Trains ``--arch`` (its SMOKE config with ``--smoke``, else the full one)
on :class:`~repro_torch.data.tokens.TokenPipeline` batches with the
:class:`~repro_torch.train.trainer.Trainer`: checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` and resumes from the newest one
there.  Without ``--mesh`` it trains on one ``--device`` (default
``cuda``; ``cpu`` runs the plain versions).  ``--mesh host`` trains across
``--ranks`` ranks started by ``run_ranks`` on ``--backend`` (``nccl``: one
rank a card; ``gloo``: on ``--device``, several ranks sharing a card
included, asked for by name), over the ``("data", "model")`` mesh of
``--mesh-shape`` (default (1, ranks), the reference's host mesh) under the
train rules with the config's overrides: data-parallel over ``"data"`` and
tensor-parallel over ``"model"`` (each layer's heads, MLP columns, experts,
SSM or RG-LRU channels and the vocab split over the ``"model"`` ranks, its
weights gathered over ``"data"`` one layer at a time), so the default
shape trains tensor-parallel.  ``--mesh single|multi`` (the
reference's 256/512-device TPU pod meshes) is ROADMAP queue A.17 and
raises.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, \
    run_ranks
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer

RANKS_TIMEOUT = 7 * 24 * 3600.0     # a training run's ranks: no deadline



def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None,
                    choices=["host", "single", "multi"],
                    help="train across ranks (default: one device)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of --mesh host")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process group of --mesh host")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model sizes of --mesh host (default 1,ranks)")
    args = ap.parse_args(argv)
    if args.mesh is None and (args.backend or args.mesh_shape
                              or args.ranks != 1):
        ap.error("--ranks, --backend and --mesh-shape need --mesh host")
    if args.mesh == "host" and args.backend is None:
        ap.error("--mesh host needs --backend nccl or gloo")
    return args


def _setup(args):
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir,
        grad_compression=args.grad_compression,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
    )
    data = iter(TokenPipeline(cfg.vocab_size, args.seq, args.batch,
                              d_model=cfg.d_model,
                              embed_inputs=cfg.embed_inputs, mrope=cfg.mrope))
    return cfg, tcfg, data


def _train_rank(argv, shape) -> dict:
    """One rank of ``--mesh host``: its trainer over the host mesh."""
    args = _parse(argv)
    cfg, tcfg, data = _setup(args)
    device = "cuda" if args.backend == "nccl" else args.device
    mesh = make_host_mesh(shape)
    tr = Trainer(cfg, tcfg, mesh=mesh, device=device)
    _, hist = tr.run(data)
    return {"history": hist, "step": tr.step, "name": cfg.name,
            "mesh": tuple(mesh.shape)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse(argv)
    if args.mesh in ("single", "multi"):
        make_production_mesh(multi_pod=args.mesh == "multi")
    if args.mesh == "host":
        shape = None if args.mesh_shape is None else tuple(
            int(n) for n in args.mesh_shape.split(","))
        out = run_ranks(_train_rank, args.ranks, backend=args.backend,
                        args=(argv, shape), timeout=RANKS_TIMEOUT,
                        threads=1 if args.device == "cpu" else None)[0]
        hist, step, name = out["history"], out["step"], out["name"]
        where = f"ranks={args.ranks} backend={args.backend} " \
                f"mesh={out['mesh']}"
    else:
        cfg, tcfg, data = _setup(args)
        tr = Trainer(cfg, tcfg, device=args.device)
        _, hist = tr.run(data)
        step, name = tr.step, cfg.name
        dev = tr.device
        where = "device=" + (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu")
    for h in hist:
        print(f"step {h['step']:6d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f}")
    print(f"done: {step} steps, arch={name}, {where}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
