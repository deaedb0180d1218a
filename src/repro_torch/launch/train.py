"""Training launcher: port of ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --smoke --steps 200 --batch 8 --seq 128 [--device cpu]

Trains ``--arch`` (its SMOKE config with ``--smoke``, else the full one)
on :class:`~repro_torch.data.tokens.TokenPipeline` batches with the
:class:`~repro_torch.train.trainer.Trainer`: checkpoints every
``--ckpt-every`` steps under ``--ckpt-dir`` and resumes from the newest one
there.  The reference's ``--mesh`` (a host or production mesh) has no
counterpart: the port trains on one ``--device`` (default ``cuda``; ``cpu``
runs the plain versions); training across ranks is ROADMAP queue A.16c.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None) -> int:
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
    args = ap.parse_args(argv)

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
    tr = Trainer(cfg, tcfg, device=args.device)
    _, hist = tr.run(data)
    for h in hist:
        print(f"step {h['step']:6d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f}")
    dev = tr.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"done: {tr.step} steps, arch={cfg.name}, device={name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
