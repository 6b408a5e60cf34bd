"""Batched serving engine: the port of ``repro/serve/engine.py``.

Slot-based batching, as in the reference: a round admits up to
``batch_slots`` queued requests, left-pads their prompts with ``pad_id`` to
the longest one, runs one prefill, then step-synchronized greedy decode
with a host read of the sampled tokens each step, until every sequence hits
EOS, its token budget or the cache end; the next round takes the next
requests.  The batch is the admitted count, not ``batch_slots``.

As in the reference, the pad tokens are not masked: a left-padded prompt's
queries attend to the pad positions.  The port keeps this on purpose, so
that both backends give the same tokens.

``submit`` validates the prompt against the KV-cache geometry up front,
every request records why it finished (``finish_reason``: ``"eos"`` |
``"budget"`` | ``"seq_limit"``), and every round appends a
:class:`RoundStats` to ``round_log``.  The reference's ``prefill_traces`` /
``decode_traces`` count jit traces; eager PyTorch has none, so the port
has no such counters.

The engine casts the parameter matrices and biases to ``compute_dtype``
once, at construction, where the reference casts its f32 weights at every
use: the values are bit-identical, and a full-width bf16 decode step does
not re-read and re-cast the f32 weights.  What the reference reads in f32
stays f32: the norm scales, and a Mamba block's ``ln``, ``gate_norm``,
``A_log``, ``D`` and ``dt_bias``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as mapi

# params the model reads in f32 (the subtrees under these keys)
F32_KEYS = ("ln1", "ln2", "final_norm", "ln", "gate_norm", "A_log", "D", "dt_bias")


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)
    done: bool = False
    # "eos" (hit eos_id), "budget" (max_new_tokens emitted) or "seq_limit"
    # (the shared decode position hit max_seq first) — None while in flight
    finish_reason: str | None = None


@dataclass(frozen=True)
class RoundStats:
    """One serve round's shape, recorded in ``Engine.round_log``."""

    admitted: int        # requests actually served this round
    batch: int           # batch size used (== admitted, not batch_slots)
    prefill_len: int     # KV positions written at prefill
    decode_steps: int    # decode calls made after prefill


def cast_for_compute(params: dict, compute_dtype, device) -> dict:
    """Matrices, biases and conv weights to ``compute_dtype`` on ``device``;
    what the model reads in f32 (``F32_KEYS``: norm scales, the Mamba
    block's decay, skip and step parameters) to f32."""
    def conv(tree, f32=False):
        if isinstance(tree, dict):
            return {k: conv(v, f32 or k in F32_KEYS) for k, v in tree.items()}
        if isinstance(tree, list):
            return [conv(v, f32) for v in tree]
        return tree.to(device=device, dtype=torch.float32 if f32 else compute_dtype)

    return conv(params)


class Engine:
    def __init__(self, cfg: ModelConfig, params: dict, *, batch_slots: int = 4,
                 max_seq: int = 256, compute_dtype=torch.bfloat16, pad_id: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_slots = batch_slots
        self.max_seq = max_seq
        self.pad_id = pad_id
        self.api = mapi.get_api(cfg, compute_dtype=compute_dtype, device=self.device)
        self.params = cast_for_compute(params, compute_dtype, self.device)
        self._queue: list[Request] = []
        self._rid = itertools.count()
        self.round_log: list[RoundStats] = []

    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: int | None = None) -> Request:
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt: prefill needs at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens does not fit the "
                f"KV cache: prefill would fill {len(prompt)} of "
                f"max_seq={self.max_seq} positions, leaving no room to "
                f"decode — shorten the prompt or raise max_seq")
        r = Request(next(self._rid), prompt, max_new_tokens, eos_id)
        self._queue.append(r)
        return r

    def _admit(self) -> list[Request]:
        batch, self._queue = (self._queue[: self.batch_slots],
                              self._queue[self.batch_slots:])
        return batch

    def run(self) -> list[Request]:
        """Serve everything queued; returns completed requests."""
        done: list[Request] = []
        while self._queue:
            done.extend(self._serve_round(self._admit()))
        return done

    @torch.inference_mode()
    def _serve_round(self, reqs: list[Request]) -> list[Request]:
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.full((b, plen), self.pad_id, np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad to align ends
        cache = self.api.init_cache(b, self.max_seq)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self.api.prefill(self.params, batch, cache)
        pos = plen
        budget = max(r.max_new_tokens for r in reqs)
        next_tok = logits.argmax(-1)
        decode_steps = 0
        for _ in range(budget):
            tok_host = next_tok.cpu().numpy()
            for i, r in enumerate(reqs):
                if r.done:
                    continue
                t = int(tok_host[i])
                r.output.append(t)
                if r.eos_id is not None and t == r.eos_id:
                    r.done = True
                    r.finish_reason = "eos"
                elif len(r.output) >= r.max_new_tokens:
                    r.done = True
                    r.finish_reason = "budget"
            if all(r.done for r in reqs):
                break
            if pos >= self.max_seq:
                break
            logits, cache = self.api.decode(self.params, next_tok, pos, cache)
            next_tok = logits.argmax(-1)
            pos += 1
            decode_steps += 1
        for r in reqs:
            if not r.done:
                # the shared decode position hit max_seq before this
                # request's budget — a truncation, not a completion
                r.done = True
                r.finish_reason = "seq_limit"
        self.round_log.append(RoundStats(admitted=len(reqs), batch=b,
                                         prefill_len=plen, decode_steps=decode_steps))
        return reqs
