#!/usr/bin/env python3
"""Compare ``flash_attention``'s index launch (``positions=None``) between
two checkouts bit for bit, on the card.

    python3 tools/flash_bits.py --tree build/parent --out A.pt
    python3 tools/flash_bits.py --tree . --out B.pt
    python3 tools/flash_bits.py --compare A.pt B.pt

Each ``--tree`` run builds that checkout's kernels (under its own
``build/``) and saves the kernel's outputs on seeded inputs: the tier
models' prefill shapes (8 × 80 tokens: Qwen3-8B, Qwen1.5-0.5B,
RecurrentGemma-9B with its window, Moonshot-v1-16B-A3B, Mixtral-8x22B with
its window), a window that binds (2 × 100, window 16) and the SMOKE head
dims 16 and 8, in float32 and bfloat16.  ``--compare`` prints how many
cases are equal bit for bit and exits 1 if any differs.  Run each tree in
its own process: both packages are named ``repro_torch``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

# name: (B, H, KV, S, D, window)
CASES = {"cloud": (8, 32, 8, 80, 128, None), "edge": (8, 16, 16, 80, 64, None),
         "recurrentgemma": (8, 16, 1, 80, 256, 2048),
         "window": (2, 8, 2, 100, 64, 16), "smoke16": (2, 4, 4, 48, 16, None),
         "smoke8": (2, 8, 2, 48, 8, None), "moonshot": (8, 16, 16, 80, 128, None),
         "mixtral": (8, 48, 8, 80, 128, 4096)}


def outputs(tree: Path) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(tree.resolve() / "src"))
    from repro_torch.kernels.flash_attention.ops import flash_attention

    dev = torch.device("cuda")
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, (b, h, kv, s, d, window) in CASES.items():
            rng = np.random.default_rng(b * s + d)

            def proj(n):
                x = rng.normal(size=(b, s, n, d)).astype(np.float32)
                return torch.from_numpy(x).to(dev).to(dt).transpose(1, 2)

            q, k, v = proj(h), proj(kv), proj(kv)
            out[f"{name} {str(dt)[6:]}"] = flash_attention(
                q, k, v, window=window, force="kernel").cpu()
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args()
    import torch

    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        print(f"flash_attention positions=None: {len(a) - len(differ)} of "
              f"{len(a)} cases bit-equal" + (f"; differ: {differ}"
                                             if differ else ""))
        return 1 if differ or set(a) != set(b) else 0
    if args.tree is None or args.out is None:
        ap.error("--tree and --out, or --compare")
    if not torch.cuda.is_available():
        print("flash_bits: CUDA is not available", file=sys.stderr)
        return 1
    torch.save(outputs(args.tree), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
