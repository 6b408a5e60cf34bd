"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Phases, each of which must pass (any failed check raises and exits non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build of every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all at once), timed;
  3. each kernel at the main paths' shapes against its plain PyTorch version
     on the card, with the tolerance stated (bit-equality for the quantization
     kernels' wire outputs, at every bucket size the [train] phase
     quantizes; one bf16 ulp for RMSNorm), and timed beside the plain
     version, one PyTorch library call computing the same function where
     there is one, its bound and the launch floor (a near-empty launch);
     RMSNorm's two row layouts timed across row counts;
  4. qwen2-1.5b at full width cut to 2 layers: prefill logits on the card
     (kernels, bf16) against the same weights on the CPU (plain versions, f32);
  5. serving at full width: ``Engine`` over all 28 layers of qwen2-1.5b in bf16
     answers 8 requests, with every kernel launch counter read over this phase
     alone;
  5b. [logits-hybrid] zamba2-2.7b at full width cut to one group (6 Mamba2
     layers and the shared block): prefill and 4 decode steps on the card
     (kernels, bf16) against the same weights on the CPU (plain versions, f32);
  5c. [serve-hybrid] ``Engine`` over all 54 layers of zamba2-2.7b in bf16
     answers 8 requests, every launch counter read over this phase alone and
     held to its exact count (RMSNorm 127 and attention 9 per forward, the
     SSD scan 54 per prefill and none per decode);
  6. [train-check] qwen2-1.5b at full width cut to 2 layers: the EF
     invariant on the card; the gradient sync (bucketing, the CUDA EF kernel,
     write-back) and AdamW on the card against the CPU from the same
     gradients, EF residuals and params, leaf by leaf; one whole
     ``planned_sharded_compressed`` train step on the card (f32 params, bf16
     compute) against the same step on the CPU in f32;
  7. [train] training at full width and depth: ``repro_torch.train.Trainer``
     takes 6 steps of qwen2-1.5b (batch 4 x 512) with the compressed planned
     sharded sync on a one-rank mesh, with every launch counter read over this
     phase alone.
The line before the last holds the kernels' JSON record; the last line is the
device record.  Needs a CUDA card: without one it exits non-zero with no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import qwen2_1_5b, zamba2_2_7b  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM, shard_batch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rmsnorm_kernel  # noqa: E402
from repro_torch.models import api as mapi  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.parallel.mesh import ProcessMesh  # noqa: E402
from repro_torch.serve.engine import cast_for_compute  # noqa: E402
from repro_torch.train import Trainer, TrainerOptions  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths, map_tensors, parts  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:17"),
    "gqa_attention": ("src/repro_torch/kernels/csrc/attention.cu",
                      "src/repro/kernels/flash_attention.py:28"),
    "ef_quantize_bucketize": ("src/repro_torch/kernels/csrc/quant.cu",
                              "src/repro/kernels/quant.py:64"),
    "quantize_blocks": ("src/repro_torch/kernels/csrc/quant.cu",
                        "src/repro/kernels/quant.py:24"),
    "dequant_add": ("src/repro_torch/kernels/csrc/quant.cu",
                    "src/repro/kernels/quant.py:32"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd.cu",
                 "src/repro/kernels/mamba_scan.py:27"),
}
# the kernels each main path must launch
PATH_KERNELS = {"serve": ("rmsnorm", "gqa_attention"),
                "serve-hybrid": ("rmsnorm", "gqa_attention", "ssd_scan"),
                "train": ("rmsnorm", "gqa_attention", "ef_quantize_bucketize")}

# RMSNorm: the kernel and the plain version round the same f32 math to bf16
# separately, so an element may differ by one bf16 ulp of its value, no more
# (f32 outputs: 1e-5 relative, the summation order)
RMSNORM_F32_RTOL = 1e-5
# attention: bf16 outputs round separately from the same f32 math: two bf16
# ulps (2^-7 relative) on values of O(1)..O(10)
ATTENTION_TOL = 2e-2
# the SSD scan against its plain version on the same inputs, elementwise
# |got - want| <= tol * (1 + |want|) on y and on the final state: the same f32
# math summed in another order over 128-step chunks.  Sound kernels read
# 1.3e-6 on an H100 80GB HBM3 at 700 W; the plain version's outputs rounded
# to bf16 (the control, checked at the main row) read near 2^-9 and fail.
# 20x under the reference's own kernel tolerance (tests/test_kernels.py, 2e-3)
SSD_TOL = 1e-4
# full-width logits, bf16 on the card vs f32 on the CPU, as a share of the
# largest |logit|: bf16 rounds activations to 2^-8 at a few dozen places
LOGITS_REL_TOL = 2e-2
# [logits-hybrid], zamba2-2.7b at full width cut to one group at seed 0: the
# card against the CPU's plain versions at the same precision, as a share of
# the largest |logit|, per step (prefill and each decode step).  Readings on
# an H100 80GB HBM3 at 700 W: f32 3.07e-6..3.80e-6, held at ~5x, so that a
# fault in the path (a cache write, the conv state, the ring) cannot hide in
# rounding; bf16 0.0106..0.0136, two bf16 paths rounding apart as far as the
# CPU's bf16 alone is from f32 (0.0151..0.0205), held at 1.5x
HYBRID_F32_TOL = 2e-5
HYBRID_BF16_TOL = 2e-2
# [train-check], qwen2-1.5b at full width cut to 2 layers, batch 1 x 64, at
# seed 0; each limit is set from a reading on an H100 80GB HBM3 at 700 W.
# (b) The gradient sync and AdamW from the same inputs on both sides, as the
# largest |card - CPU| of a leaf over the CPU leaf's largest |value|.  The
# synced gradients and the EF residuals are the quantization's wire outputs
# and its exact remainder: bit-equal by the kernel's contract (reading 0).
# Params and moments: two f32 ulps of the leaf's largest value (reading
# 6.91e-8 on the params, 0 on the moments).
SYNC_WIRE_TOL = 0.0
ADAMW_LEAF_TOL = 2.4e-7
# (c) One whole step, card (bf16 compute) vs CPU (f32), as a share of the
# CPU's value: loss (reading 5.1e-4) and grad norm (1.85e-5) at 4x and 5x
# the reading; each leaf's update as a norm at 2x the reading (0.129), where
# a missing, doubled or reversed update reads 1 or more.
STEP_LOSS_TOL = 2e-3
STEP_GNORM_TOL = 1e-4
STEP_UPDATE_TOL = 0.25

# the quantization kernels' shapes besides the [train] phase's bucket sizes
# (train_buckets): a full 32 MiB bucket (the cap; no bucket of qwen2-1.5b
# fills it) and a ragged small one
QUANT_EXTRA_SIZES = {"32 MiB": 8 * 2**20, "n=5000": 5000}
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 512


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one call: the calls are queued behind a sleep kernel
    so that the host's launch overhead does not open gaps between them
    (inputs stay in L2 across calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def launch_floor_ms() -> float:
    """The device time of a near-empty launch queued like the kernels' (the
    floor under every [kernel] time)."""
    return device_ms(lambda: torch.cuda._sleep(0))


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (8 significant bits)."""
    v = v.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def train_config(seed: int, steps: int = TRAIN_STEPS, compute_dtype: str = "bfloat16"
                 ) -> TrainConfig:
    """The training path's config: the compressed planned sharded sync
    through the CUDA EF kernel, at 8 bits on every bucket (at one rank the
    planner would decline compression everywhere)."""
    return TrainConfig(sync_algorithm="planned_sharded_compressed", compress_fused_kernel=True,
                       compress_bits=(8,), remat="full", total_steps=steps, seed=seed,
                       compute_dtype=compute_dtype)


def train_buckets(cfg, tc: TrainConfig) -> dict[str, int]:
    """The distinct sizes of the buckets the gradient sync quantizes on a
    one-rank mesh, largest first, each labelled by the buckets of that size
    (a leaf over the 32 MiB cap is a bucket of its own)."""
    params = TS.abstract_params(cfg)
    spec = TS.SyncController(params, tc, ProcessMesh({"data": 1})).plans.spec
    names = ["/".join(map(str, path)) for path, _ in leaves_with_paths(params)]

    def label(bucket: int) -> str:
        held = [nm for nm, b in zip(names, spec.leaf_buckets) if b == bucket]
        return held[0] if len(held) == 1 else f"{held[0]} + {len(held) - 1} more"

    return {" | ".join(label(i) for i, m in enumerate(spec.bucket_sizes) if m == n): n
            for n in sorted(set(spec.bucket_sizes), reverse=True)}


# --------------------------------------------------------------------- phases

def check_rmsnorm(got, want, what: str) -> float:
    """bf16: every element within one bf16 ulp of the plain version's; f32:
    within RMSNORM_F32_RTOL relative.  Returns the largest |difference|."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        excess = float((diff / bf16_ulp(want)).max())
        check(excess <= 1.0, f"rmsnorm {what}: {excess} bf16 ulps from its plain version")
    else:
        rel = float((diff / want.float().abs().clamp_min(1e-30)).max())
        check(rel <= RMSNORM_F32_RTOL, f"rmsnorm {what}: rel err {rel} from its plain version")
    return float(diff.max())


def phase_rmsnorm(dev, rows: int, d: int) -> dict:
    x = torch.randn(rows, d, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, device=dev))          # f32 scale, as in the model
    got = ops.rmsnorm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    err = check_rmsnorm(got, ref.rmsnorm_ref(x, w, eps=1e-6), f"[{rows},{d}]")
    check(torch.equal(ops.rmsnorm(x, w, eps=1e-6), got),
          f"rmsnorm [{rows},{d}]: a second call on the same inputs differs")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # mixed-dtype weight: not the fused path
        lib = device_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
    b_ms, b_by = bound(2 * rows * d * 2 + d * 4, 4 * rows * d, F32_FLOPS)
    return {"shape": f"x[{rows},{d}] bf16, w[{d}] f32", "max_abs_err": err,
            "ms": device_ms(lambda: ops.rmsnorm(x, w, eps=1e-6)),
            "plain_ms": device_ms(lambda: ref.rmsnorm_ref(x, w, eps=1e-6)),
            "library_ms": lib, "library": "torch.nn.functional.rms_norm",
            "bound_ms": b_ms, "bound_by": b_by}


def phase_rmsnorm_layouts(dev, widths, row_counts) -> list[dict]:
    """The readings that set the kernel's kWideRows: device time of a block
    per row (layout 1) against warps per row (layout 2) at each row count and
    width, bf16 x and f32 w, each layout checked against the plain version."""
    out = []
    for d in widths:
        w = 1.0 + 0.1 * torch.randn(d, device=dev)
        for n in row_counts:
            x = torch.randn(n, d, device=dev).to(torch.bfloat16)
            want = ref.rmsnorm_ref(x, w, eps=1e-6)
            row = {"rows": n, "d": d}
            for layout, key in ((1, "block_per_row_ms"), (2, "warps_per_row_ms")):
                check_rmsnorm(rmsnorm_kernel._launch(x, w, 1e-6, layout=layout), want,
                              f"[{n},{d}] layout {layout}")
                row[key] = device_ms(lambda: rmsnorm_kernel._launch(x, w, 1e-6, layout=layout))
            out.append(row)
    return out


def _visible(sq: int, q_offset: int, kv_len: int, window: int | None, causal: bool,
             dev=None) -> torch.Tensor:
    """[sq, kv_len] bool: the keys each query sees."""
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(kv_len, device=dev)[None, :]
    vis = kpos <= qpos if causal else torch.ones(sq, kv_len, dtype=torch.bool, device=dev)
    if window is not None:
        vis &= (qpos - kpos) < window
    return vis


def phase_attention(dev, name, b, sq, smax, h, kh, d, q_offset, kv_len, window,
                    causal=True) -> dict:
    bf = torch.bfloat16
    q = torch.randn(b, sq, h, d, device=dev).to(bf)
    k = torch.randn(b, smax, kh, d, device=dev).to(bf)
    v = torch.randn(b, smax, kh, d, device=dev).to(bf)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kw)
    check(bool(torch.isfinite(got.float()).all()), f"attention {name}: non-finite output")
    # the split-KV merge (the last block of each KV head, by atomic ticket)
    # sums in split order: a second call gives the same bits
    check(torch.equal(ops.flash_attention(q, k, v, **kw), got),
          f"attention {name}: a second call on the same inputs differs")
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTENTION_TOL, f"attention {name} disagrees with its plain version: "
                                f"max |err| {err}")

    # the library yardstick: one SDPA call over the same keys
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kv_len], v[:, :kv_len]))
    mask = _visible(sq, q_offset, kv_len, window, causal, dev)
    lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                           enable_gqa=True))

    pairs = int(mask.sum())
    lo = 0 if window is None else max(0, q_offset - window + 1)
    kv_rows = kv_len - lo
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * kv_rows * kh * d)   # q, o; k, v once
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs * b * h, BF16_FLOPS)
    return {"shape": (f"{name}: q[{b},{sq},{h},{d}] kv[{b},{smax},{kh},{d}] bf16, "
                      f"q_offset {q_offset}, kv_len {kv_len}, window {window}, causal {causal}"),
            "max_abs_err": err,
            "ms": device_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=10),
            "library_ms": lib, "library": "torch.nn.functional.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by}


def _ssd_inputs(dev, b, s, h, p, n, dtype, seed):
    """x, B, C as the Mamba block hands them to the scan: strided slices of
    one conv output [b, s, h*p + 2n], in the compute dtype."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    conv = torch.randn(b, s, h * p + 2 * n, device=dev, generator=gen).to(dtype)
    x = conv[..., :h * p].reshape(b, s, h, p)
    bm, cm = conv[..., h * p:h * p + n], conv[..., h * p + n:]
    dt = torch.rand(b, s, h, device=dev, generator=gen) * 0.19 + 0.01
    a = -(torch.rand(h, device=dev, generator=gen) * 1.5 + 0.5)
    return x, dt, a, bm, cm


def _ssd_work(b, s, h, p, n, q, in_bytes, passes=(1, 1, 1, 1)) -> tuple[float, float]:
    """(bytes, flops) the SSD scan needs: x, B, C, dt, a read once, y and the
    final state written once; per (batch, head) and chunk of qv valid rows
    the lower triangle of C·Bᵀ and of G·xbar (qv(qv+1)/2 pairs, N and P
    deep) and the two N x P products with the state.  ``passes`` counts
    each product (C·Bᵀ, G·x, C·h, Bᵀ·x) that many times, as a kernel that
    runs it in several tensor-core passes does."""
    nbytes = in_bytes * (b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h) \
        + 4 * (b * s * h * p + b * h * n * p)
    p_cb, p_gx, p_ch, p_bx = passes
    flops = 0.0
    for t0 in range(0, s, q):
        qv = min(q, s - t0)
        tri = qv * (qv + 1) / 2
        flops += 2.0 * (tri * (n * p_cb + p * p_gx) + qv * n * p * (p_ch + p_bx))
    return nbytes, flops * b * h


# the bf16 SSD kernel's precision scheme: C·Bᵀ in one bf16 tensor-core pass,
# the three products with an f32 factor in two (its hi and lo bf16 parts)
SSD_BF16_PASSES = (1, 2, 2, 2)


def phase_ssd(dev, name, b, s, h, p, n, chunk, dtype, seed) -> dict:
    inputs = _ssd_inputs(dev, b, s, h, p, n, dtype, seed)
    y, state = ops.ssd_scan(*inputs, chunk=chunk)
    torch.cuda.synchronize()
    want_y, want_state = ref.ssd_chunked_ref(*inputs, chunk=chunk)
    err, excess = 0.0, 0.0
    for got, want, what in ((y, want_y, "y"), (state, want_state, "final state")):
        check(bool(torch.isfinite(got).all()), f"ssd_scan {name}: non-finite {what}")
        diff = (got - want).abs()
        err = max(err, float(diff.max()))
        excess = max(excess, float((diff / (1 + want.abs())).max()))
    check(excess <= SSD_TOL, f"ssd_scan {name} disagrees with ssd_chunked_ref: "
                             f"max |err| / (1 + |want|) {excess} (tol {SSD_TOL})")
    # the control: the plain version's y and state stored in bf16, as a kernel
    # that kept either in bf16 would give; the limit must tell it apart
    control = max(float(((w.bfloat16().float() - w).abs() / (1 + w.abs())).max())
                  for w in (want_y, want_state))
    # a second call gives the same bits (no atomics, fixed summation order)
    for again, first in zip(ops.ssd_scan(*inputs, chunk=chunk), (y, state)):
        check(torch.equal(again, first), f"ssd_scan {name}: a second call differs")
    # the bound at the rate of the kernel's own arithmetic: bf16 inputs run
    # on the tensor cores (the split products twice), f32 inputs as f32
    # FMAs; the f32-peak figure of the first kernel is kept beside it
    q = min(chunk, s)
    nbytes, flops = _ssd_work(b, s, h, p, n, q, dtype.itemsize)
    b32_ms, b32_by = bound(nbytes, flops, F32_FLOPS)
    if dtype == torch.bfloat16:
        _, tc_flops = _ssd_work(b, s, h, p, n, q, dtype.itemsize, SSD_BF16_PASSES)
        b_ms, b_by = bound(nbytes, tc_flops, BF16_FLOPS)
    else:
        tc_flops, b_ms, b_by = flops, b32_ms, b32_by
    tname = "bf16" if dtype == torch.bfloat16 else "f32"
    return {"shape": (f"{name}: x[{b},{s},{h},{p}] B/C[{b},{s},{n}] {tname} strided views, "
                      f"chunk {min(chunk, s)}"),
            "max_abs_err": err, "max_scaled_err": excess, "bf16_control_scaled_err": control,
            "ms": device_ms(lambda: ops.ssd_scan(*inputs, chunk=chunk)),
            "plain_ms": device_ms(lambda: ref.ssd_chunked_ref(*inputs, chunk=chunk), iters=5),
            "library_ms": None, "library": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_f32_peak_ms": b32_ms, "bound_f32_peak_by": b32_by,
            "flops": flops, "flops_at_kernel_precision": tc_flops, "bytes": nbytes}


def phase_ssd_sequential(dev, seed) -> float:
    """The kernel against the sequential recurrence (the ground truth) at a
    small shape; returns the largest scaled error."""
    inputs = _ssd_inputs(dev, 2, 70, 3, 32, 16, torch.float32, seed)
    excess = 0.0
    for got, want in zip(ops.ssd_scan(*inputs, chunk=32), ref.ssd_ref(*inputs)):
        excess = max(excess, float(((got - want).abs() / (1 + want.abs())).max()))
    check(excess <= SSD_TOL, f"ssd_scan vs ssd_ref: {excess} (tol {SSD_TOL})")
    return excess


def _bit_equal(got, want, what: str) -> float:
    """Raise unless every tensor equals its plain twin bit for bit; returns
    the largest |difference| (0.0)."""
    for a, b in zip(got, want):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b),
              f"{what} differs from its plain version")
    return max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))


def phase_quant(dev, label: str, n: int, bits: int, block: int = 1024) -> dict:
    """The three quantization kernels on one bucket of ``n`` f32 values,
    bit-equal to their plain versions, timed and bounded (bytes: each input
    read once, each output written once; operations counted per element in
    f32 on the CUDA cores).  No single PyTorch call computes any of them."""
    g = torch.randn(n, device=dev)
    e = 0.01 * torch.randn(n, device=dev)
    nb = -(-n // block)
    n_pad = nb * block
    plain_iters = 5 if n > 10**7 else 20
    rows = {}

    ef = lambda: ops.ef_quantize_bucketize(g, e, block=block, bits=bits)  # noqa: E731
    got = ef()
    torch.cuda.synchronize()
    want = ref.ef_quantize_bucketize_ref(g, e, block=block, bits=bits)
    err = _bit_equal(got[:4], want[:4], f"ef_quantize_bucketize {label} bits {bits}")
    q, scales = got[0], got[1]
    del got, want
    b_ms, b_by = bound(8 * n + 9 * n_pad + 4 * nb, 9 * n, F32_FLOPS)
    rows["ef_quantize_bucketize"] = dict(
        ms=device_ms(ef), plain_ms=device_ms(
            lambda: ref.ef_quantize_bucketize_ref(g, e, block=block, bits=bits),
            iters=plain_iters), max_abs_err=err, bound_ms=b_ms, bound_by=b_by)

    qb = lambda: ops.quantize_blocks(g, block=block, bits=bits)  # noqa: E731
    got = qb()
    torch.cuda.synchronize()
    err = _bit_equal(got[:2], ref.quantize_blocks_ref(g, block=block, bits=bits)[:2],
                     f"quantize_blocks {label} bits {bits}")
    del got
    b_ms, b_by = bound(4 * n + n_pad + 4 * nb, 6 * n, F32_FLOPS)
    rows["quantize_blocks"] = dict(
        ms=device_ms(qb), plain_ms=device_ms(
            lambda: ref.quantize_blocks_ref(g, block=block, bits=bits), iters=plain_iters),
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by)

    acc = torch.zeros(n_pad, device=dev)     # the reference's round trip: 0 + dequant(q)
    acc[:n] = e
    da = lambda: ops.dequant_add(q, scales, acc, block=block)  # noqa: E731
    got = da()
    torch.cuda.synchronize()
    err = _bit_equal([got], [ref.dequant_add_ref(q, scales, acc, block=block)],
                     f"dequant_add {label} bits {bits}")
    del got
    b_ms, b_by = bound(n_pad + 4 * nb + 8 * n_pad, 2 * n_pad, F32_FLOPS)
    rows["dequant_add"] = dict(
        ms=device_ms(da), plain_ms=device_ms(
            lambda: ref.dequant_add_ref(q, scales, acc, block=block), iters=plain_iters),
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by)
    for r in rows.values():
        r.update(shape=f"{label}: [{n}] f32, block {block}, bits {bits}", library_ms=None,
                 library=None)
    del g, e, q, scales, acc
    torch.cuda.empty_cache()
    return rows


def phase_full_width_logits(dev, seed: int) -> dict:
    cfg = dataclasses.replace(qwen2_1_5b.CONFIG, n_layers=2)
    gen = torch.Generator().manual_seed(seed)
    params = transformer.init_params(cfg, gen, device="cpu", dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, 32)))
    cpu = mapi.get_api(cfg, compute_dtype=torch.float32, device="cpu")
    gpu = mapi.get_api(cfg, compute_dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        want, _ = cpu.prefill(params, {"tokens": toks}, cpu.init_cache(1, 64, torch.float32))
        got, _ = gpu.prefill(cast_for_compute(params, torch.bfloat16, dev),
                             {"tokens": toks.to(dev)}, gpu.init_cache(1, 64))
    got, want = got.float().cpu()[:, :cfg.vocab_size], want[:, :cfg.vocab_size]
    check(bool(torch.isfinite(got).all()), "full-width logits: non-finite values")
    rel = float((got - want).abs().max() / want.abs().max())
    check(rel <= LOGITS_REL_TOL, f"full-width logits: card vs CPU max rel err {rel}")
    return {"max_rel_err": rel, "top1_agrees": bool((got.argmax(-1) == want.argmax(-1)).all())}


def _hybrid_logits(api, params, toks, prompt: int, n_decode: int, cache, vocab: int):
    """Last-token logits (f32, on the CPU) of a prefill of ``toks[:, :prompt]``
    and of each of the ``n_decode`` decode steps after it."""
    out = []
    with torch.inference_mode():
        logits, cache = api.prefill(params, {"tokens": toks[:, :prompt]}, cache)
        out.append(logits)
        for step in range(n_decode):
            logits, cache = api.decode(params, toks[:, prompt + step], prompt + step, cache)
            out.append(logits)
    return [o.float().cpu()[:, :vocab] for o in out]


def _rel_by_step(got, want) -> list[float]:
    return [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]


def phase_hybrid_logits(dev, seed: int, n_decode: int = 4) -> dict:
    """zamba2-2.7b at full width cut to one group (6 Mamba2 layers and the
    shared block), batch 1: a 160-token prefill (two SSD chunks, the second
    ragged) and ``n_decode`` decode steps on the same weights, card (kernels)
    against CPU (plain versions): bf16 on the card against f32 on the CPU,
    and each precision against itself (bf16 with bf16 caches, f32 with f32
    caches)."""
    cfg = dataclasses.replace(zamba2_2_7b.CONFIG, n_layers=zamba2_2_7b.CONFIG.attn_every)
    params = ssm.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(1, cfg.vocab_size,
                                                                 (1, 160 + n_decode)))
    runs = {}
    for where, device in (("cpu", "cpu"), ("card", dev)):
        for dtype in (torch.float32, torch.bfloat16):
            api = mapi.get_api(cfg, compute_dtype=dtype, device=device)
            runs[where, dtype] = _hybrid_logits(
                api, cast_for_compute(params, dtype, device), toks.to(device), 160, n_decode,
                api.init_cache(1, 192, dtype), cfg.vocab_size)
    for dtype in (torch.float32, torch.bfloat16):
        for step, g in enumerate(runs["card", dtype]):
            check(bool(torch.isfinite(g).all()), f"hybrid logits {dtype} step {step}: non-finite")
    want = runs["cpu", torch.float32]
    rels = _rel_by_step(runs["card", torch.bfloat16], want)
    bf16_rels = _rel_by_step(runs["card", torch.bfloat16], runs["cpu", torch.bfloat16])
    f32_rels = _rel_by_step(runs["card", torch.float32], want)
    check(max(rels) <= LOGITS_REL_TOL,
          f"hybrid logits: card bf16 vs CPU f32 max rel err {rels} (tol {LOGITS_REL_TOL})")
    check(max(bf16_rels) <= HYBRID_BF16_TOL,
          f"hybrid logits: card bf16 vs CPU bf16 max rel err {bf16_rels} "
          f"(tol {HYBRID_BF16_TOL})")
    check(max(f32_rels) <= HYBRID_F32_TOL,
          f"hybrid logits: card f32 vs CPU f32 max rel err {f32_rels} (tol {HYBRID_F32_TOL})")
    top1 = [bool((g.argmax(-1) == w.argmax(-1)).all())
            for g, w in zip(runs["card", torch.bfloat16], want)]
    return {"layers": cfg.n_layers, "prompt": 160, "decode_steps": n_decode,
            "max_rel_err_by_step": rels, "max_rel_err": max(rels), "top1_agrees_by_step": top1,
            "bf16_vs_cpu_bf16_by_step": bf16_rels, "f32_vs_cpu_f32_by_step": f32_rels,
            # the model's own bf16 error: the plain versions alone, no kernel
            "cpu_bf16_vs_f32_by_step": _rel_by_step(runs["cpu", torch.bfloat16], want)}


def _expected_launches(cfg, prefills: int, decodes: int) -> dict[str, int]:
    """Kernel launches of ``prefills`` prefills (prompts over one token) and
    ``decodes`` decode steps; serving runs no quantization kernel."""
    want = {name: 0 for name in ops.KERNELS}
    forwards = prefills + decodes
    if cfg.family == "hybrid":
        groups = cfg.n_layers // cfg.attn_every
        # per Mamba layer ln + gate_norm, per group the shared block's ln1 + ln2, one final
        want.update(rmsnorm=(2 * cfg.n_layers + 2 * groups + 1) * forwards,
                    gqa_attention=groups * forwards, ssd_scan=cfg.n_layers * prefills)
    else:
        want.update(rmsnorm=(2 * cfg.n_layers + 1) * forwards,
                    gqa_attention=cfg.n_layers * forwards)
    return want


def phase_serve(dev, seed: int, cfg=qwen2_1_5b.CONFIG, n_requests: int = 8,
                profile_dir: str | None = None) -> dict:
    """``Engine`` over the whole model at full width in bf16, random weights
    from ``seed``: 8 requests of 16-256 prompt tokens, 32 new tokens each,
    4 slots, max_seq 512."""
    model = ssm if cfg.family == "hybrid" else transformer
    torch.cuda.reset_peak_memory_stats(dev)   # the set-up peak is this phase's own
    t0 = time.perf_counter()
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                               device=dev, dtype=torch.float32)
    eng = Engine(cfg, params, batch_slots=4, max_seq=512, compute_dtype=torch.bfloat16,
                 device=dev)
    del params
    torch.cuda.empty_cache()
    setup_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)   # f32 init + the bf16 copy

    # time each forward on the host clock, synchronized; check its logits
    times = {"prefill": [], "decode": []}

    def timed(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t)
            check(logits.shape[-1] == cfg.padded_vocab and bool(torch.isfinite(logits).all()),
                  f"{kind}: logits of shape {tuple(logits.shape)} or non-finite")
            return logits, cache
        return call

    eng.submit(list(range(1, 17)), max_new_tokens=2)   # warm-up: cuBLAS, allocator
    eng.run()
    api = eng.api
    eng.api = dataclasses.replace(api, prefill=timed("prefill", api.prefill),
                                  decode=timed("decode", api.decode))
    eng.round_log.clear()

    rng = np.random.default_rng(seed)
    reqs = [eng.submit([int(t) for t in rng.integers(1, cfg.vocab_size, int(n))],
                       max_new_tokens=32)
            for n in rng.integers(16, 257, n_requests)]
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()

    check(len(done) == n_requests, f"served {len(done)} of {n_requests} requests")
    for r in reqs:
        check(r.finish_reason in ("eos", "budget", "seq_limit") and r.output
              and all(0 <= t < cfg.vocab_size for t in r.output),
              f"request {r.rid}: finish_reason {r.finish_reason}, output {r.output[:4]}")
    prefills = len(eng.round_log)
    decodes = sum(r.decode_steps for r in eng.round_log)
    forwards = prefills + decodes
    check(prefills == len(times["prefill"]) and decodes == len(times["decode"]),
          "forward count")
    want = _expected_launches(cfg, prefills, decodes)
    check(counts == want, f"kernel launches {counts}, expected {want} for {prefills} "
                          f"prefills and {decodes} decode steps")

    tokens = sum(len(r.output) for r in reqs)
    result = {
        "requests": n_requests, "rounds": [dataclasses.asdict(r) for r in eng.round_log],
        "prompt_lens": [len(r.prompt) for r in reqs], "generated_tokens": tokens,
        "model": cfg.name, "layers": cfg.n_layers, "forwards": forwards,
        "prefills": prefills, "decode_steps": decodes, "launches": counts,
        "prefill_ms": [t * 1e3 for t in times["prefill"]],
        # one decode step emits the next token of every sequence in the batch
        "decode_ms_per_token": float(np.mean(times["decode"]) * 1e3),
        "tokens_per_s": tokens / wall, "wall_s": wall, "setup_s": setup_s,
        "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
        "init_peak_memory_gib": init_peak / 2**30,
        "finish_reasons": sorted({r.finish_reason for r in reqs}),
    }
    if profile_dir:
        eng.api = api
        result["profile"] = profile_round(eng, profile_dir, cfg.name)
    return result


def profile_round(eng, out_dir: str, name: str) -> dict:
    """torch.profiler over one more round of 4 requests: device time by
    kernel (table written to ``out_dir``), by kernel family, and the
    device's busy share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    for n in (64, 128, 192, 256):
        eng.submit(list(range(1, n + 1)), max_new_tokens=8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    forwards = 1 + eng.round_log[-1].decode_steps
    summary = _trace_summary(prof, Path(out_dir) / f"serve_{name}_profile.txt")
    return {"forwards": forwards, "kernels_per_forward": summary["kernels"] / forwards,
            **summary}


# kernel families for the device-time breakdowns, by name
KERNEL_FAMILIES = (("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
                   ("ef_quantize", ("quant_",)), ("rmsnorm", ("rmsnorm",)),
                   ("ssd_scan", ("ssd_scan",)),
                   ("attention", ("gqa", "attention")), ("elementwise", ("elementwise",)),
                   ("reduce", ("reduce",)), ("index", ("index", "embedding", "gather", "scatter")),
                   ("copy", ("copy", "cat", "memcpy", "memset")))


def _family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES if any(k in low for k in keys)), "other")


def _trace_summary(prof, table_path: Path) -> dict:
    """Write the profiler's table to ``table_path`` and the traced kernels'
    count and device time by full name beside it (``*.kernels.json``, for
    diffing two runs); from its trace (parsed in a temporary directory, it
    is tens of MB) the kernel count, the device's busy share of the traced
    span, and device time by family."""
    table_path.parent.mkdir(parents=True, exist_ok=True)
    table_path.write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    families: dict[str, float] = {}
    by_name: dict[str, list] = {}     # name -> [count, device us]
    for e in kernels:
        fam = _family(e["name"])
        families[fam] = families.get(fam, 0.0) + e["dur"] / 1e3
        count_us = by_name.setdefault(e["name"], [0, 0.0])
        count_us[0] += 1
        count_us[1] += e["dur"]
    table_path.with_suffix(".kernels.json").write_text(json.dumps(
        dict(sorted(by_name.items(), key=lambda kv: -kv[1][1])), indent=0))
    busy = sum(e["dur"] for e in kernels)
    return {"kernels": len(kernels), "device_busy_share": busy / span, "wall_ms": span / 1e3,
            "device_ms": busy / 1e3,
            "device_ms_by_family": dict(sorted(families.items(), key=lambda kv: -kv[1]))}


def profile_train_step(cfg, tc: TrainConfig, mesh, state, batch, dev, out_dir: str) -> dict:
    """torch.profiler over one more train step: device time by kernel family
    and the device's busy share of the step's wall time (table written to
    ``out_dir``)."""
    from torch.profiler import ProfilerActivity, profile

    step = TS.make_train_step(cfg, tc, mesh, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    return _trace_summary(prof, Path(out_dir) / "train_profile.txt")


def step_parts_ms(cfg, tc: TrainConfig, mesh, plans, state, batch, dev) -> dict:
    """One more step in its three parts, each closed by a synchronize, on
    the host clock: forward + backward, the gradient sync (EF quantization
    on one rank), AdamW.  The second of two runs is kept."""
    api = mapi.get_api(cfg, compute_dtype=torch.bfloat16, device=dev, remat=tc.remat)
    for _ in range(2):
        marks = [time.perf_counter()]
        _, _, grads = TS._microbatched_grads(api.loss, state["params"], batch, 1)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads, _ = TS.sync_gradients(grads, tc, mesh, state["ef"], sync_plans=plans)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        adamw_update(grads, state["opt"], state["params"], torch.tensor(tc.lr), tc)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        del grads
    names = ("forward_backward_ms", "grad_sync_ms", "optimizer_ms")
    return {n: (b - a) * 1e3 for n, a, b in zip(names, marks, marks[1:])}


def _ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _fresh_state(params, device) -> dict:
    p = map_tensors(lambda t: t.detach().to(device, copy=True).requires_grad_(), params)
    return {"params": p, "opt": adamw_init(p), "step": torch.zeros((), dtype=torch.int32),
            "ef": map_tensors(lambda t: torch.zeros_like(t.detach()), p)}


def _copy(tree, device):
    return map_tensors(lambda t: t.detach().to(device, copy=True), tree)


def _leaf_gaps(card, cpu) -> dict[str, float]:
    """Per leaf: the largest |card - CPU| over the CPU leaf's largest |value|."""
    gaps = {}
    for (path, a), (_, b) in zip(leaves_with_paths(card), leaves_with_paths(cpu)):
        a = torch.cat([t.detach().reshape(-1).float().cpu() for t in parts(a)])
        b = torch.cat([t.detach().reshape(-1).float() for t in parts(b)])
        gaps["/".join(map(str, path))] = float((a - b).abs().max()
                                               / b.abs().max().clamp_min(1e-30))
    return gaps


def _update_gaps(card, cpu, before) -> dict[str, float]:
    """Per leaf: ||update on the card - update on the CPU|| / ||update on the
    CPU||, the updates being each side's params less ``before`` (0 where
    neither side moved the leaf, inf where only the card did)."""
    gaps = {}
    for (path, a), (_, b), (_, p0) in zip(leaves_with_paths(card), leaves_with_paths(cpu),
                                          leaves_with_paths(before)):
        p0 = torch.cat([t.detach().reshape(-1).float() for t in parts(p0)])
        a = torch.cat([t.detach().reshape(-1).float().cpu() for t in parts(a)]) - p0
        b = torch.cat([t.detach().reshape(-1).float() for t in parts(b)]) - p0
        num, den = float((a - b).norm()), float(b.norm())
        gaps["/".join(map(str, path))] = num / den if den else (0.0 if num == 0 else math.inf)
    return gaps


def _worst(gaps: dict[str, float]) -> tuple[str, float]:
    return max(gaps.items(), key=lambda kv: kv[1])


def phase_train_check(dev, seed: int) -> dict:
    """qwen2-1.5b at full width cut to 2 layers, batch 1 x 64, the training
    path's config:
      (a) the EF invariant on the card: deq + new residual == grad (the old
          residual is 0), to one ulp of the gradient;
      (b) the part of a step after the gradients, from the same gradients
          (the card's), EF residuals (those (a) left) and params on both
          sides: ``sync_gradients`` (bucketing, the CUDA EF kernel or its
          plain version, write-back) and ``adamw_update`` at the peak lr;
          synced gradients, new residuals, params and moments leaf by leaf;
      (c) one whole ``make_train_step`` step, card (bf16 compute) vs CPU
          (f32), from a state past the warmup (at step 0 the lr is 0): loss,
          grad norm and each leaf's update (AdamW's first update is close to
          lr * sign(grad), so bf16 gradients flip the update of their
          smallest elements: a norm of the difference, not its largest
          element, reads this)."""
    cfg = dataclasses.replace(qwen2_1_5b.CONFIG, n_layers=2)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    batch = SyntheticLM(cfg.vocab_size, 64, 1, seed=seed).batch(0)
    mesh = ProcessMesh({"data": 1})
    cpu = torch.device("cpu")
    tc_card, tc_cpu = train_config(seed), train_config(seed, compute_dtype="float32")

    # (a)
    state = _fresh_state(params, dev)
    api = mapi.get_api(cfg, compute_dtype=torch.bfloat16, device=dev, remat="full")
    _, _, grads = TS._microbatched_grads(api.loss, state["params"],
                                         shard_batch(batch, mesh, dev), 1)
    grads_in = _copy(grads, cpu)
    local = [t.clone() for leaf in leaves(grads) for t in parts(leaf)]
    plans = TS.SyncController(TS.abstract_params(cfg), tc_card, mesh).plans
    check(set(plans.bits) == {8}, f"bits {plans.bits}: compress_bits=(8,) forces 8")
    before = ops.launch_counts()["ef_quantize_bucketize"]
    synced, new_ef = TS.sync_gradients(grads, tc_card, mesh, state["ef"], sync_plans=plans)
    torch.cuda.synchronize()
    check(ops.launch_counts()["ef_quantize_bucketize"] - before == len(plans.bits),
          "the EF kernel runs once per compressed bucket")
    worst, moved = 0.0, 0.0
    for d, r, g in zip((t for leaf in leaves(synced) for t in parts(leaf)),
                       (t for leaf in leaves(new_ef) for t in parts(leaf)), local):
        worst = max(worst, float(((d + r - g).abs() / _ulp(g).clamp_min(1e-45)).max()))
        moved = max(moved, float(r.abs().max()))
    check(worst <= 1.0, f"EF invariant: deq + residual is {worst} ulps from the gradient")
    check(moved > 0, "EF residual is zero everywhere: nothing was quantized")
    ef_in = _copy(new_ef, cpu)
    del state, grads, synced, new_ef, local
    torch.cuda.empty_cache()

    # (b)
    after = {}
    for side, device in (("card", dev), ("cpu", cpu)):
        g, e, p = _copy(grads_in, device), _copy(ef_in, device), _copy(params, device)
        opt = adamw_init(p)
        g, e = TS.sync_gradients(g, tc_card, mesh, e, sync_plans=plans)
        adamw_update(g, opt, p, torch.tensor(tc_card.lr), tc_card)
        after[side] = {"synced_grads": g, "ef": e, "params": p, "m": opt["m"], "v": opt["v"]}
    sync = {k: _worst(_leaf_gaps(after["card"][k], after["cpu"][k])) for k in after["card"]}
    del after, grads_in, ef_in
    torch.cuda.empty_cache()
    for k, (leaf, gap) in sync.items():
        tol = SYNC_WIRE_TOL if k in ("synced_grads", "ef") else ADAMW_LEAF_TOL
        check(gap <= tol, f"sync + AdamW from the same inputs: {k} {leaf} card vs CPU "
                          f"{gap} of the leaf's max (tol {tol})")

    # (c)
    out, p_after = {}, {}
    for side, tc, device in (("card", tc_card, dev), ("cpu", tc_cpu, cpu)):
        state = _fresh_state(params, device)
        state["step"] = torch.tensor(tc.warmup_steps, dtype=torch.int32)
        step = TS.make_train_step(cfg, tc, mesh, device=device)
        state, m = step(state, shard_batch(batch, mesh, device))
        out[side] = {k: float(v) for k, v in m.items()}
        p_after[side] = state["params"]
        del state, step
    check(math.isclose(out["card"]["lr"], tc_card.lr, rel_tol=1e-6),
          f"lr {out['card']['lr']}: the step is not past the warmup")
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    for k, tol in (("loss", STEP_LOSS_TOL), ("grad_norm", STEP_GNORM_TOL)):
        check(math.isfinite(out["card"][k]) and rel[k] <= tol,
              f"train step {k}: card {out['card'][k]} vs CPU {out['cpu'][k]} "
              f"(rel {rel[k]}, tol {tol})")
    p_leaf, p_gap = _worst(_update_gaps(p_after["card"], p_after["cpu"], params))
    del p_after
    torch.cuda.empty_cache()
    check(p_gap <= STEP_UPDATE_TOL, f"train step: the update of {p_leaf}, card vs CPU, "
                                    f"{p_gap} of the CPU's (tol {STEP_UPDATE_TOL})")
    return {"card": out["card"], "cpu": out["cpu"], "rel_err": rel,
            "update": {"leaf": p_leaf, "gap": p_gap},
            "sync_adamw_same_inputs": {k: {"leaf": leaf, "gap": gap}
                                       for k, (leaf, gap) in sync.items()},
            "ef_invariant_max_ulps": worst, "max_residual": moved, "buckets": len(plans.bits)}


def phase_train(dev, seed: int, checked_sizes, steps: int = TRAIN_STEPS,
                batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                profile_dir: str | None = None) -> dict:
    """Full-width, full-depth qwen2-1.5b through ``Trainer`` on a one-rank
    mesh with the compressed planned sharded sync (``train_config``); every
    bucket size it quantizes must be among ``checked_sizes``, those [quant]
    held bit-equal."""
    cfg = qwen2_1_5b.CONFIG
    tc = train_config(seed, steps)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        t0 = time.perf_counter()
        trainer = Trainer(cfg, tc, SyntheticLM(cfg.vocab_size, seq, batch, seed=seed),
                          mesh=ProcessMesh({"data": 1}), device=dev,
                          options=TrainerOptions(ckpt_dir=ckpt_dir, ckpt_every=10**9,
                                                 log_every=1))
        plans = trainer.controller.plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state = trainer.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in trainer.history]
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    check(int(state["step"]) == steps, f"state step {int(state['step'])}")
    n_buckets = len(plans.spec.bucket_sizes)
    check(set(plans.bits) == {8}, f"bits {plans.bits}")
    check(set(plans.spec.bucket_sizes) <= set(checked_sizes),
          f"bucket sizes {sorted(set(plans.spec.bucket_sizes) - set(checked_sizes))} were not "
          f"held against the plain version")
    check(counts["ef_quantize_bucketize"] == n_buckets * steps,
          f"EF kernel launches {counts['ef_quantize_bucketize']}, expected one per bucket "
          f"and step ({n_buckets} x {steps})")
    for name in PATH_KERNELS["train"]:
        check(counts[name] > 0, f"{name} was not launched while training")
    history = trainer.history

    # where a step's time goes, on the trained state (launches no longer counted)
    mesh = trainer.mesh
    one = shard_batch(trainer.source.batch(0), mesh, dev)
    parts_ms = step_parts_ms(cfg, tc, mesh, plans, state, one, dev)
    prof = profile_train_step(cfg, tc, mesh, state, one, dev, profile_dir) if profile_dir else None
    del trainer, state, one
    torch.cuda.empty_cache()

    # the EF kernel's device time per step: each bucket's shape timed alone
    ef_ms = 0.0
    for size in plans.spec.bucket_sizes:
        g, e = torch.randn(size, device=dev), torch.randn(size, device=dev)
        ef_ms += device_ms(lambda: ops.ef_quantize_bucketize(g, e, block=tc.compress_block),
                           iters=10)
        del g, e
    torch.cuda.empty_cache()
    ms = [h["sec_per_step"] * 1e3 for h in history]
    return {
        "steps": steps, "batch": batch, "seq": seq, "tokens_per_step": batch * seq,
        "losses": losses, "ms_per_step": ms,
        "mean_ms_per_step_after_first": float(np.mean(ms[1:])),
        "ef_kernel_ms_per_step": ef_ms,
        "launches": counts, "launches_per_step": {k: v / steps for k, v in counts.items()},
        "buckets": [{"elements": n, "bits": b} for n, b in
                    zip(plans.spec.bucket_sizes, plans.bits)],
        "peak_memory_gib": peak / 2**30, "wall_s": wall, "setup_s": t1 - t0,
        "step_parts_ms": parts_ms, **({"profile": prof} if prof else {}),
    }


# ----------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="also write torch.profiler tables of one serve round and one "
                         "train step here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # the f32 paths are references
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(args.seed)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    t_start = t0 = time.perf_counter()
    build_logs = _build.build(force=True, ptxas_info=True)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(build_logs)} in {build_s:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "Function properties for" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    cfg = qwen2_1_5b.CONFIG
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    zcfg = zamba2_2_7b.CONFIG
    zhd, zH, zK, zwin = zcfg.resolved_head_dim, zcfg.n_heads, zcfg.n_kv_heads, zcfg.sliding_window
    _, d_inner, nheads, _ = ssm._dims(zcfg)
    zs = zcfg.ssm
    smoke = zamba2_2_7b.SMOKE
    _, _, s_heads, _ = ssm._dims(smoke)
    floor = launch_floor_ms()
    log(f"[kernel] launch floor (torch.cuda._sleep(0), queued like the kernels): "
        f"{floor * 1e3:.2f} us")
    phases = {
        "rmsnorm": [phase_rmsnorm(dev, 4 * 256, cfg.d_model),     # prefill rows B*S
                    phase_rmsnorm(dev, 4, cfg.d_model),           # decode rows
                    # zamba2: ln, ln1, ln2 and the final norm at d_model, the gate norm
                    # at d_inner; prefill and decode rows
                    phase_rmsnorm(dev, 4 * 256, zcfg.d_model),
                    phase_rmsnorm(dev, 4, zcfg.d_model),
                    phase_rmsnorm(dev, 4 * 256, d_inner),
                    phase_rmsnorm(dev, 4, d_inner),
                    # the [train] phase's rows, batch x seq
                    phase_rmsnorm(dev, TRAIN_BATCH * TRAIN_SEQ, cfg.d_model)],
        "gqa_attention": [
            phase_attention(dev, "prefill", 4, 256, 512, H, K, hd, 0, 256, None),
            phase_attention(dev, "decode", 4, 1, 512, H, K, hd, 511, 512, None),
            phase_attention(dev, "decode-short", 4, 1, 512, H, K, hd, 287, 288, None),
            phase_attention(dev, "window", 4, 256, 512, H, K, hd, 0, 256, 64),
            # zamba2's shared block: head_dim 80; decode reads its ring cache
            phase_attention(dev, "zamba2 prefill", 4, 256, 256, zH, zK, zhd, 0, 256, zwin),
            phase_attention(dev, "zamba2 decode", 4, 1, 512, zH, zK, zhd, 0, 512, None,
                            causal=False),
            # the [train] phase: causal over the step's own keys, no cache
            phase_attention(dev, "train", TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, H, K, hd, 0,
                            TRAIN_SEQ, None),
        ],
        "ssd_scan": [
            # the serving prefill as the model hands it over (bf16 views): the main row
            phase_ssd(dev, "prefill", 4, 256, nheads, zs.head_dim, zs.state_dim, zs.chunk,
                      torch.bfloat16, args.seed),
            phase_ssd(dev, "prefill f32", 4, 256, nheads, zs.head_dim, zs.state_dim, zs.chunk,
                      torch.float32, args.seed + 1),
            phase_ssd(dev, "ragged", 4, 200, nheads, zs.head_dim, zs.state_dim, zs.chunk,
                      torch.bfloat16, args.seed + 2),
            phase_ssd(dev, "smoke", 2, 64, s_heads, smoke.ssm.head_dim, smoke.ssm.state_dim,
                      smoke.ssm.chunk, torch.float32, args.seed + 3),
        ],
    }
    control = phases["ssd_scan"][0]["bf16_control_scaled_err"]
    check(control > SSD_TOL, f"ssd_scan: the bf16-rounded control reads {control}, "
                             f"within the limit {SSD_TOL}")
    log(f"[kernel] ssd_scan control, the plain version's outputs rounded to bf16: max |err| / "
        f"(1 + |want|) {control:.3g}, over the limit {SSD_TOL} as it must be")
    ssd_seq = phase_ssd_sequential(dev, args.seed)
    log(f"[kernel] ssd_scan vs the sequential ssd_ref: max |err| / (1 + |want|) "
        f"{ssd_seq:.3g} (tol {SSD_TOL})")
    # the [train] phase's bucket sizes first, the largest (the main row) leading
    quant_sizes = {**train_buckets(cfg, train_config(args.seed)), **QUANT_EXTRA_SIZES}
    for label, n in quant_sizes.items():
        for bits in (8, 4):
            for name, row in phase_quant(dev, label, n, bits).items():
                phases.setdefault(name, []).append(row)
    log(f"[time] {time.perf_counter() - t_start:.1f} s")
    for name, rows in phases.items():
        for p in rows:
            lib = "none" if p["library_ms"] is None else f"{p['library_ms'] * 1e3:.2f} us"
            b32 = (f", f32-peak bound {p['bound_f32_peak_ms'] * 1e3:.3f} us, max |err| / "
                   f"(1 + |want|) {p['max_scaled_err']:.3g}" if "bound_f32_peak_ms" in p else "")
            log(f"[kernel] {name} {p['shape']}: max|err| {p['max_abs_err']:.3g}, "
                f"{p['ms'] * 1e3:.2f} us (floor {floor * 1e3:.2f} us, plain "
                f"{p['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
                f"{p['bound_ms'] * 1e3:.3f} us by {p['bound_by']}{b32})")
    # the rows' layout: a block per row against warps per row, from decode
    # to training row counts (the readings behind rmsnorm.cu's kWideRows)
    layouts = phase_rmsnorm_layouts(dev, (cfg.d_model, zcfg.d_model, d_inner),
                                    (1, 4, 16, 64, 132, 264, 528, 1024, 2048))
    for r in layouts:
        log(f"[kernel] rmsnorm layouts [{r['rows']},{r['d']}] bf16: a block per row "
            f"{r['block_per_row_ms'] * 1e3:.2f} us, warps per row "
            f"{r['warps_per_row_ms'] * 1e3:.2f} us")
    log(f"[time] {time.perf_counter() - t_start:.1f} s")

    logits = phase_full_width_logits(dev, args.seed)
    log(f"[logits] qwen2-1.5b full width, 2 layers, 32 tokens: card bf16 vs CPU f32 "
        f"max rel err {logits['max_rel_err']:.3g} (tol {LOGITS_REL_TOL}), "
        f"top-1 agrees {logits['top1_agrees']}")

    serve = phase_serve(dev, args.seed, profile_dir=args.profile)
    log(f"[serve] {json.dumps(serve)}")
    log(f"[time] {time.perf_counter() - t_start:.1f} s")

    hlogits = phase_hybrid_logits(dev, args.seed)
    by_step = lambda key: [float(f"{r:.4g}") for r in hlogits[key]]  # noqa: E731
    log(f"[logits-hybrid] zamba2-2.7b full width, {hlogits['layers']} layers, prefill of "
        f"{hlogits['prompt']} tokens and {hlogits['decode_steps']} decode steps, max rel err "
        f"by step: card bf16 vs CPU f32 {by_step('max_rel_err_by_step')} (tol "
        f"{LOGITS_REL_TOL}), top-1 agrees {hlogits['top1_agrees_by_step']}; card bf16 vs CPU "
        f"bf16 {by_step('bf16_vs_cpu_bf16_by_step')} (tol {HYBRID_BF16_TOL}); card f32 vs "
        f"CPU f32 {by_step('f32_vs_cpu_f32_by_step')} (tol {HYBRID_F32_TOL}); the plain "
        f"versions on the CPU alone, bf16 vs f32 {by_step('cpu_bf16_vs_f32_by_step')}")
    log(f"[time] {time.perf_counter() - t_start:.1f} s")

    hserve = phase_serve(dev, args.seed, cfg=zamba2_2_7b.CONFIG, profile_dir=args.profile)
    log(f"[serve-hybrid] zamba2-2.7b full width and depth, bf16: decode "
        f"{hserve['decode_ms_per_token']:.2f} ms per step, prefill "
        f"{[round(t, 2) for t in hserve['prefill_ms']]} ms per round, "
        f"{hserve['tokens_per_s']:.1f} tokens/s, peak {hserve['peak_memory_gib']:.2f} GiB "
        f"(set-up {hserve['init_peak_memory_gib']:.2f} GiB); {json.dumps(hserve)}")
    torch.cuda.empty_cache()   # the engine is gone: free its weights before training
    log(f"[time] {time.perf_counter() - t_start:.1f} s")

    check_ = phase_train_check(dev, args.seed)
    same = check_["sync_adamw_same_inputs"]
    log(f"[train-check] qwen2-1.5b full width, 2 layers, batch 1 x 64: EF invariant within "
        f"{check_['ef_invariant_max_ulps']:.3g} ulp over {check_['buckets']} buckets; sync + "
        f"AdamW from the same inputs, card vs CPU, largest leaf gap: "
        + ", ".join(f"{k} {v['gap']:.3g}" for k, v in same.items())
        + f" (tol {SYNC_WIRE_TOL} synced grads and EF, {ADAMW_LEAF_TOL} params and moments); "
        f"one step card bf16 vs CPU f32: rel err loss {check_['rel_err']['loss']:.3g} "
        f"(tol {STEP_LOSS_TOL}), grad norm {check_['rel_err']['grad_norm']:.3g} "
        f"(tol {STEP_GNORM_TOL}), update {check_['update']['gap']:.3g} of the CPU's "
        f"({check_['update']['leaf']}, tol {STEP_UPDATE_TOL}); {json.dumps(check_)}")

    train = phase_train(dev, args.seed, quant_sizes.values(), profile_dir=args.profile)
    log(f"[train] qwen2-1.5b full width and depth, {train['steps']} steps of "
        f"{train['batch']} x {train['seq']}: {train['mean_ms_per_step_after_first']:.1f} ms "
        f"per step (after the first), EF kernel {train['ef_kernel_ms_per_step']:.3f} ms per step, peak "
        f"{train['peak_memory_gib']:.2f} GiB, losses {train['losses']}")
    log(f"[train] step parts {json.dumps(train['step_parts_ms'])}")
    log(f"[train] launches per step {json.dumps(train['launches_per_step'])}; buckets "
        f"{json.dumps(train['buckets'])}")
    log(f"[train] {json.dumps(train)}")

    log(f"[time] {time.perf_counter() - t_start:.1f} s")
    by_path = {"serve": serve["launches"], "serve-hybrid": hserve["launches"],
               "train": train["launches"]}
    for path, names in PATH_KERNELS.items():
        for name in names:
            check(by_path[path][name] > 0, f"{name} was not launched on the {path} path")
    record = {"kernels": []}
    for name, rows in phases.items():
        main_row = rows[0]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(p["max_abs_err"] for p in rows),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            "phases": rows,
        })
    record["launch_floor_ms"] = floor
    record["rmsnorm_layouts"] = layouts
    record["ssd_scan_vs_sequential"] = ssd_seq
    record["build_s"] = build_s
    record["wall_s"] = time.perf_counter() - t_start
    record["card"] = card
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
