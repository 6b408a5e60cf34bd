"""GPU smoke of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Phases, each of which must pass (any failed check raises and exits non-zero):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build of every CUDA kernel of the serving path from ``src/repro_torch/kernels/csrc``
     (one nvcc per source, all at once), timed;
  3. each kernel at the serving path's shapes against its plain PyTorch version
     on the card, with the tolerance stated, and timed beside the plain version,
     one PyTorch library call computing the same function, and its bound;
  4. qwen2-1.5b at full width cut to 2 layers: prefill logits on the card
     (kernels, bf16) against the same weights on the CPU (plain versions, f32);
  5. serving at full width: ``Engine`` over all 28 layers of qwen2-1.5b in bf16
     answers 8 requests, with every kernel launch counter read over this phase
     alone.
The line before the last holds the kernels' JSON record; the last line is the
device record.  Needs a CUDA card: without one it exits non-zero with no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import qwen2_1_5b  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import api as mapi  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402
from repro_torch.serve.engine import cast_for_compute  # noqa: E402

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
}

# bf16 outputs of the kernel and of the plain version round separately from
# the same f32 math: two bf16 ulps (2^-7 relative) on values of O(1)..O(10)
RMSNORM_TOL = 2e-2
ATTENTION_TOL = 2e-2
# full-width logits, bf16 on the card vs f32 on the CPU, as a share of the
# largest |logit|: bf16 rounds activations to 2^-8 at a few dozen places
LOGITS_REL_TOL = 2e-2


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


# --------------------------------------------------------------------- phases

def phase_rmsnorm(dev, rows: int, d: int) -> dict:
    x = torch.randn(rows, d, device=dev).to(torch.bfloat16)
    w = (1.0 + 0.1 * torch.randn(d, device=dev))          # f32 scale, as in the model
    got = ops.rmsnorm(x, w, eps=1e-6)
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, eps=1e-6)
    err = float((got.float() - want.float()).abs().max())
    check(err <= RMSNORM_TOL * max(1.0, float(want.float().abs().max())),
          f"rmsnorm [{rows},{d}] disagrees with its plain version: max |err| {err}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # mixed-dtype weight: not the fused path
        lib = device_ms(lambda: F.rms_norm(x, (d,), w, 1e-6))
    b_ms, b_by = bound(2 * rows * d * 2 + d * 4, 4 * rows * d, F32_FLOPS)
    return {"shape": f"x[{rows},{d}] bf16, w[{d}] f32", "max_abs_err": err,
            "ms": device_ms(lambda: ops.rmsnorm(x, w, eps=1e-6)),
            "plain_ms": device_ms(lambda: ref.rmsnorm_ref(x, w, eps=1e-6)),
            "library_ms": lib, "library": "torch.nn.functional.rms_norm",
            "bound_ms": b_ms, "bound_by": b_by}


def _visible_pairs(sq: int, q_offset: int, kv_len: int, window: int | None) -> int:
    qpos = q_offset + np.arange(sq)[:, None]
    kpos = np.arange(kv_len)[None, :]
    vis = kpos <= qpos
    if window is not None:
        vis &= (qpos - kpos) < window
    return int(vis.sum())


def phase_attention(dev, name, b, sq, smax, h, kh, d, q_offset, kv_len, window) -> dict:
    bf = torch.bfloat16
    q = torch.randn(b, sq, h, d, device=dev).to(bf)
    k = torch.randn(b, smax, kh, d, device=dev).to(bf)
    v = torch.randn(b, smax, kh, d, device=dev).to(bf)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kw)
    check(bool(torch.isfinite(got.float()).all()), f"attention {name}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= ATTENTION_TOL, f"attention {name} disagrees with its plain version: "
                                f"max |err| {err}")

    # the library yardstick: one SDPA call over the same keys
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k[:, :kv_len], v[:, :kv_len]))
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(kv_len, device=dev)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    lib = device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                           enable_gqa=True))

    pairs = _visible_pairs(sq, q_offset, kv_len, window)
    lo = 0 if window is None else max(0, q_offset - window + 1)
    kv_rows = kv_len - lo
    nbytes = 2 * (2 * b * sq * h * d + 2 * b * kv_rows * kh * d)   # q, o; k, v once
    b_ms, b_by = bound(nbytes, 4.0 * d * pairs * b * h, BF16_FLOPS)
    return {"shape": (f"{name}: q[{b},{sq},{h},{d}] kv[{b},{smax},{kh},{d}] bf16, "
                      f"q_offset {q_offset}, kv_len {kv_len}, window {window}"),
            "max_abs_err": err,
            "ms": device_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            "plain_ms": device_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), iters=10),
            "library_ms": lib, "library": "torch.nn.functional.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by}


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


def phase_serve(dev, seed: int, n_requests: int = 8, profile_dir: str | None = None) -> dict:
    cfg = qwen2_1_5b.CONFIG
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
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
    forwards = len(eng.round_log) + sum(r.decode_steps for r in eng.round_log)
    check(forwards == len(times["prefill"]) + len(times["decode"]), "forward count")
    want = {"rmsnorm": (2 * cfg.n_layers + 1) * forwards, "gqa_attention": cfg.n_layers * forwards}
    check(counts == want, f"kernel launches {counts}, expected {want} for {forwards} forwards")

    tokens = sum(len(r.output) for r in reqs)
    result = {
        "requests": n_requests, "rounds": [dataclasses.asdict(r) for r in eng.round_log],
        "prompt_lens": [len(r.prompt) for r in reqs], "generated_tokens": tokens,
        "forwards": forwards, "launches": counts,
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
        result["profile"] = profile_round(eng, profile_dir)
    return result


def profile_round(eng, out_dir: str) -> dict:
    """torch.profiler over one more round of 4 requests: device time by
    kernel (table and trace written to ``out_dir``) and the device's busy
    share of the round's wall time."""
    from torch.profiler import ProfilerActivity, profile

    for n in (64, 128, 192, 256):
        eng.submit(list(range(1, n + 1)), max_new_tokens=8)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    (out / "serve_profile.txt").write_text(table)
    trace = out / "serve_trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    forwards = 1 + eng.round_log[-1].decode_steps
    return {"forwards": forwards, "kernels_per_forward": len(kernels) / forwards,
            "device_busy_share": sum(e["dur"] for e in kernels) / span,
            "wall_ms": span / 1e3}


# ----------------------------------------------------------------------- main

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", default=None,
                    help="also write a torch.profiler table and trace of one serve round here")
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

    t0 = time.perf_counter()
    build_logs = _build.build(force=True, ptxas_info=True)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(build_logs)} in {build_s:.1f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    cfg = qwen2_1_5b.CONFIG
    hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    phases = {
        "rmsnorm": [phase_rmsnorm(dev, 4 * 256, cfg.d_model),     # prefill rows B*S
                    phase_rmsnorm(dev, 4, cfg.d_model)],          # decode rows
        "gqa_attention": [
            phase_attention(dev, "prefill", 4, 256, 512, H, K, hd, 0, 256, None),
            phase_attention(dev, "decode", 4, 1, 512, H, K, hd, 511, 512, None),
            phase_attention(dev, "decode-short", 4, 1, 512, H, K, hd, 287, 288, None),
            phase_attention(dev, "window", 4, 256, 512, H, K, hd, 0, 256, 64),
        ],
    }
    for name, rows in phases.items():
        for p in rows:
            log(f"[kernel] {name} {p['shape']}: max|err| {p['max_abs_err']:.3g}, "
                f"{p['ms'] * 1e3:.2f} us (plain {p['plain_ms'] * 1e3:.2f} us, "
                f"library {p['library_ms'] * 1e3:.2f} us, bound {p['bound_ms'] * 1e3:.3f} us "
                f"by {p['bound_by']})")

    logits = phase_full_width_logits(dev, args.seed)
    log(f"[logits] qwen2-1.5b full width, 2 layers, 32 tokens: card bf16 vs CPU f32 "
        f"max rel err {logits['max_rel_err']:.3g} (tol {LOGITS_REL_TOL}), "
        f"top-1 agrees {logits['top1_agrees']}")

    serve = phase_serve(dev, args.seed, profile_dir=args.profile)
    log(f"[serve] {json.dumps(serve)}")

    record = {"kernels": []}
    for name, rows in phases.items():
        main_row = rows[0]
        record["kernels"].append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": serve["launches"][name],
            "max_abs_err": max(p["max_abs_err"] for p in rows),
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
            "phases": rows,
        })
    record["build_s"] = build_s
    record["card"] = card
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
