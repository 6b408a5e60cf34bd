"""Training CLI of the port.

    # one process on the CPU (plain versions of the kernels), size-1 mesh
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
        --device cpu --sync planned_sharded_compressed --fused-kernel
    # one GPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --sync planned_sharded_compressed --fused-kernel --compress-bits 8
    # four GPUs of one host, a 2x2 (data x pod) mesh over NCCL
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-1.5b --mesh 2x2 --sync planned_sharded

Under ``torchrun`` (``RANK``/``WORLD_SIZE`` set) each process joins the job
(NCCL on the card, gloo on the CPU) and drives ``cuda:LOCAL_RANK``; one
process with no such variables runs a size-1 mesh.  The reference's
``--data corpus`` waits for ``CorpusLM``'s port: the data is ``SyntheticLM``.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.parallel.mesh import ProcessMesh
from repro_torch.runtime.fault_tolerance import FailureInjector
from repro_torch.train import Trainer, TrainerOptions
from repro_torch.train.train_step import PORTED_ALGOS


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--sync", default="planned_sharded", choices=PORTED_ALGOS)
    ap.add_argument("--sync-m", type=int, default=17)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", choices=("synthetic",), default="synthetic")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default=None,
                    help="DxP: data x pod ranks (default: every rank on 'data')")
    ap.add_argument("--fail-at", type=int, nargs="*", default=(),
                    help="inject failures at these steps (recovery demo)")
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--compress-bits", type=int, nargs="+", default=[32, 8, 4],
                    help="wire widths the planner sweeps per bucket")
    ap.add_argument("--fused-kernel", action="store_true",
                    help="quantize with the CUDA EF kernel (compress_fused_kernel)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    cfg = registry.get(args.arch, smoke=args.smoke)
    tc = TrainConfig(lr=args.lr, total_steps=args.steps,
                     warmup_steps=min(20, args.steps // 5 + 1), remat=args.remat,
                     sync_algorithm=args.sync, sync_m=args.sync_m,
                     microbatches=args.microbatches,
                     compress_bits=tuple(args.compress_bits),
                     compress_fused_kernel=args.fused_kernel)

    device = args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "RANK" in os.environ and world > 1:
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
            device = f"cuda:{torch.cuda.current_device()}"
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    if args.mesh:
        d, p = (int(x) for x in args.mesh.split("x"))
        mesh = ProcessMesh({"data": d, "pod": p})
    else:
        mesh = ProcessMesh({"data": world})

    injector = FailureInjector(tuple(args.fail_at)) if args.fail_at else None
    trainer = Trainer(cfg, tc, SyntheticLM(cfg.vocab_size, args.seq, args.batch),
                      mesh=mesh, options=TrainerOptions(ckpt_dir=args.ckpt_dir,
                                                        ckpt_every=args.ckpt_every),
                      injector=injector, device=device)
    try:
        trainer.run(args.steps)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for h in trainer.history[-5:]:
        print(h)
    return trainer.history


if __name__ == "__main__":
    main()
