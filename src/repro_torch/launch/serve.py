"""Serving CLI of the port: batched requests against a random model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --max-new 16            # on the GPU (the default)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --smoke --device cpu                 # plain PyTorch path on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \
        --max-seq 512                        # the Mamba2 hybrid, on the GPU

``--arch`` takes the architectures the port has (``registry.ARCH_IDS``).

The reference's ``--ckpt-dir`` waits for the checkpointer's port.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import api as mapi
from repro_torch.serve import Engine


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = registry.get(args.arch, smoke=args.smoke)
    api = mapi.get_api(cfg, device=args.device)
    params = api.init(args.seed)
    eng = Engine(cfg, params, batch_slots=args.batch_slots, max_seq=args.max_seq,
                 device=args.device)
    del params
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        plen = int(rng.integers(2, 12))
        eng.submit([int(t) for t in rng.integers(1, cfg.vocab_size, plen)],
                   max_new_tokens=args.max_new)
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in done)
    print(f"{len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s) on {eng.device}")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt {r.prompt[:6]}... -> {r.output}")
    return done


if __name__ == "__main__":
    main()
