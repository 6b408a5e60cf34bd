"""Routing and Wavelength Assignment (RWA) for one communication step.

The paper (Sec. III-C-2) notes that within each WRHT subgroup the
communications must be wavelength-conflict-free, and that classic greedy
assignment (First Fit / Best Fit) suffices because different subgroups never
share ring segments.

The production implementation here is array-based: each directed lightpath is
a ring arc ``(start, hops)`` on one of the two fiber lanes, per-segment
occupancy is a ``uint64`` bitmask (bit λ set iff wavelength λ is busy on that
segment), and First Fit is "OR the masks along the arc, take the lowest clear
bit".  Two further structural facts make it effectively free at scale:

* arcs on the same lane conflict only if they lie in the same *covered run*
  (maximal contiguous union of arcs), so the greedy decomposes exactly into
  independent per-run subproblems — computed with one difference-array sweep;
* WRHT steps consist of hundreds of translated copies of the same subgroup
  pattern, so identical runs (same relative arcs in the same processing
  order) are solved once and the assignment is broadcast to every copy.

Assignment order is longest-path-first with ties broken by input order —
identical to :func:`first_fit_assign_reference` (the original per-object
greedy, kept verbatim), and enforced bit-for-bit by the golden-equivalence
test in ``tests/test_rwa_equivalence.py``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np

from .topology import FailureMask, Transfer, TransferBatch, path_segments


class WavelengthConflictError(ValueError):
    pass


class InsertionLossError(ValueError):
    """A lightpath exceeds the insertion-loss hop budget (Sec. III)."""


class FailedResourceError(ValueError):
    """A schedule touches a resource the :class:`FailureMask` marks dead —
    a cut fiber span, a dead per-node wavelength, or a dead transceiver
    (DESIGN.md §12).  Raised by the validators; the degraded builder routes
    around failures so its output never trips this."""


# ---------------------------------------------------------------------------
# Failure-mask enforcement (DESIGN.md §12).
# ---------------------------------------------------------------------------

def _covers_dead_segment(batch: TransferBatch, n: int,
                         failures: FailureMask) -> np.ndarray:
    """Bool per row: the lightpath covers a cut span on its lane."""
    lane, start, hops = batch.arcs(n)
    dead = failures.segment_dead(n)
    if not dead.any():
        return np.zeros(len(batch), dtype=bool)
    # prefix-sum of dead segments per lane -> covered-count per arc in O(1)
    csum = np.concatenate([np.zeros((2, 1)), np.cumsum(dead, axis=1)], axis=1)
    end = start + hops           # may exceed n: arc wraps the origin
    wrap = np.minimum(end - n, n)
    covered = (csum[lane, np.minimum(end, n)] - csum[lane, start]
               + np.where(wrap > 0, csum[lane, np.maximum(wrap, 0)], 0.0))
    return covered > 0


def _uses_dead_transceiver(batch: TransferBatch, n: int,
                           failures: FailureMask) -> np.ndarray:
    """Bool per row: src transmits or dst receives on a dead Tx/Rx lane."""
    lane = batch.arcs(n)[0]
    dead = failures.transceiver_dead(n)
    if not dead.any():
        return np.zeros(len(batch), dtype=bool)
    return dead[batch.src % n, lane] | dead[batch.dst % n, lane]


def validate_failures(transfers, n: int, failures: FailureMask | None,
                      check_wavelengths: bool = True) -> None:
    """Reject any transfer touching a dead resource (DESIGN.md §12).

    Checks, in order: cut fiber spans (path covers a dead ``(lane,
    segment)``), dead transceivers (endpoint adds/drops on a dead lane),
    and — when ``check_wavelengths`` and the batch is assigned — dead
    per-node wavelengths (endpoint adds/drops a dead λ).  Raises
    :exc:`FailedResourceError` on the first offender.
    """
    if failures is None or failures.empty:
        return
    batch = TransferBatch.coerce(transfers)
    if len(batch) == 0:
        return
    bad = _covers_dead_segment(batch, n, failures)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise FailedResourceError(
            f"transfer {int(batch.src[i])}->{int(batch.dst[i])} traverses a "
            f"dead fiber span (lane {int(batch.arcs(n)[0][i])})"
        )
    bad = _uses_dead_transceiver(batch, n, failures)
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise FailedResourceError(
            f"transfer {int(batch.src[i])}->{int(batch.dst[i])} uses a dead "
            f"transceiver (lane {int(batch.arcs(n)[0][i])})"
        )
    if check_wavelengths and failures.dead_wavelengths:
        forbid = failures.forbidden_lambda_bits(n)
        lam = batch.wavelength
        for i in range(len(batch)):
            lm = int(lam[i])
            if lm < 0:
                continue
            if ((forbid[int(batch.src[i]) % n] >> lm) & 1
                    or (forbid[int(batch.dst[i]) % n] >> lm) & 1):
                raise FailedResourceError(
                    f"transfer {int(batch.src[i])}->{int(batch.dst[i])} "
                    f"adds/drops dead wavelength {lm}"
                )


def _first_fit_forbidden(batch: TransferBatch, n: int, w: int,
                         failures: FailureMask) -> TransferBatch:
    """First Fit honoring per-node forbidden wavelengths.

    Same processing order as the reference greedy (longest-path-first,
    stable ties), but each transfer's candidate set additionally excludes
    every λ dead at its src or dst.  Per-node forbidden sets break the
    translation-symmetry dedup of the fast path, so this is a plain
    dict-based greedy — degraded operation is rare and schedules are built
    once per plan-cache key, so the cost is immaterial (EXPERIMENTS.md
    §Degraded records it).
    """
    lane, start, hops = batch.arcs(n)
    forbid = failures.forbidden_lambda_bits(n)
    full = (1 << w) - 1
    order = np.argsort(-hops, kind="stable")
    occ: dict[tuple[int, int], int] = {}
    lam = np.empty(len(batch), dtype=np.int64)
    for i in order.tolist():
        l, s, h = int(lane[i]), int(start[i]), int(hops[i])
        used = forbid[int(batch.src[i]) % n] | forbid[int(batch.dst[i]) % n]
        segs = [(l, (s + k) % n) for k in range(h)]
        for key in segs:
            used |= occ.get(key, 0)
        free = ~used & full
        if free == 0:
            raise WavelengthConflictError(
                f"step needs more than the {w} available wavelengths under "
                f"the failure mask (transfer "
                f"{int(batch.src[i])}->{int(batch.dst[i])})"
            )
        lm = (free & -free).bit_length() - 1
        bit = 1 << lm
        for key in segs:
            occ[key] = occ.get(key, 0) | bit
        lam[i] = lm
    return batch.with_wavelengths(lam)


# ---------------------------------------------------------------------------
# Insertion-loss hop budget (physical-layer constraint).
# ---------------------------------------------------------------------------

def validate_hop_budget(transfers, n: int, max_hops: int) -> None:
    """Reject any lightpath longer than the insertion-loss hop budget.

    Vectorized like the conflict check: hop counts come straight from the
    arc representation.  Raises :exc:`InsertionLossError` on the first
    offender (a signal traversing more than ``max_hops`` MRR banks arrives
    below receiver sensitivity — see ``topology.PhysicalParams``).
    """
    batch = TransferBatch.coerce(transfers)
    if len(batch) == 0:
        return
    hops = batch.arcs(n)[2]
    bad = hops > max_hops
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise InsertionLossError(
            f"transfer {int(batch.src[i])}->{int(batch.dst[i])} traverses "
            f"{int(hops[i])} segments, exceeding the insertion-loss hop "
            f"budget of {max_hops}"
        )


def split_overlong_arcs(transfers, n: int, max_hops: int) -> list[TransferBatch]:
    """Relay decomposition of a step whose arcs may exceed the hop budget.

    Every lightpath longer than ``max_hops`` is cut into a chain of
    O/E/O-regenerated sub-paths of at most ``max_hops`` segments; the relay
    nodes are the ring nodes ``max_hops`` apart along the original path.
    Sub-path ``k`` of every chain lands in sub-step ``k`` (store-and-forward:
    a relay must finish receiving before it retransmits), so the return value
    is a list of sub-step batches to be scheduled *in order*.  Paths already
    within budget appear only in sub-step 0.

    Wavelengths are reset to unassigned (-1) on every returned batch — the
    caller re-runs RWA per sub-step, since relay chains change the conflict
    structure.
    """
    if max_hops < 1:
        raise ValueError("max_hops must be >= 1")
    batch = TransferBatch.coerce(transfers)
    if len(batch) == 0:
        return [batch]
    hops = batch.arcs(n)[2]
    chain_len = np.maximum(1, -(-hops // max_hops))  # ceil
    out: list[TransferBatch] = []
    for k in range(int(chain_len.max())):
        sel = np.flatnonzero(chain_len > k)
        direction = batch.direction[sel]
        src_k = (batch.src[sel] + k * max_hops * direction) % n
        seg_h = np.minimum(hops[sel] - k * max_hops, max_hops)
        dst_k = (src_k + seg_h * direction) % n
        out.append(TransferBatch(
            src_k, dst_k, direction, batch.bits[sel],
            np.full(sel.size, -1, dtype=np.int64),
        ))
    return out


# ---------------------------------------------------------------------------
# Reference implementation (original greedy, kept as the golden oracle).
# ---------------------------------------------------------------------------

def first_fit_assign_reference(
    transfers: Sequence[Transfer], n: int, w: int
) -> list[Transfer]:
    """Assign wavelengths greedily (First Fit, [18] in the paper).

    Transfers are processed longest-path-first (a standard RWA heuristic:
    long lightpaths are the hardest to place).  Raises if more than ``w``
    wavelengths would be needed.
    """
    # (direction, segment) -> set of wavelengths in use
    occupancy: dict[tuple[int, int], set[int]] = {}

    def segs(t: Transfer) -> list[tuple[int, int]]:
        return [(t.direction, s) for s in path_segments(t.src, t.dst, n, t.direction)]

    order = sorted(range(len(transfers)), key=lambda i: -len(segs(transfers[i])))
    assigned: list[Transfer | None] = [None] * len(transfers)
    for i in order:
        t = transfers[i]
        used = set()
        for key in segs(t):
            used |= occupancy.get(key, set())
        lam = next(l for l in range(w + len(transfers) + 1) if l not in used)
        if lam >= w:
            raise WavelengthConflictError(
                f"step needs wavelength {lam} but only {w} available "
                f"(transfer {t.src}->{t.dst})"
            )
        for key in segs(t):
            occupancy.setdefault(key, set()).add(lam)
        assigned[i] = replace(t, wavelength=lam)
    return [t for t in assigned if t is not None]


# ---------------------------------------------------------------------------
# Vectorized implementation.
# ---------------------------------------------------------------------------

def _solve_first_fit(
    rel_start: list[int],
    hops: list[int],
    w: int,
    seg_count: int,
    circular: bool,
) -> np.ndarray:
    """First-Fit one conflict component, arcs given in processing order.

    ``rel_start``/``hops`` are run-local coordinates: unless ``circular``
    (the run covers the whole ring), every arc is the contiguous slice
    ``[s, s+h)`` of a ``seg_count``-long occupancy array, so the inner OR /
    mark are single NumPy slice ops — O(1) NumPy calls per segment range.
    """
    words = (w + 63) // 64
    occ = np.zeros((words, seg_count), dtype=np.uint64)
    full = (1 << w) - 1
    lam_out = np.empty(len(rel_start), dtype=np.int64)
    for i, (s, h) in enumerate(zip(rel_start, hops)):
        e = s + h
        used = 0
        for j in range(words):
            row = occ[j]
            if e <= seg_count:
                u = int(np.bitwise_or.reduce(row[s:e]))
            else:  # circular run: arc wraps the origin
                u = int(np.bitwise_or.reduce(row[s:])) | int(
                    np.bitwise_or.reduce(row[: e - seg_count])
                )
            used |= u << (64 * j)
        free = ~used & full
        if free == 0:
            raise WavelengthConflictError(
                f"step needs more than the {w} available wavelengths "
                f"(arc start={s} hops={h})"
            )
        lam = (free & -free).bit_length() - 1
        word, bit = divmod(lam, 64)
        mask = np.uint64(1 << bit)
        row = occ[word]
        if e <= seg_count:
            row[s:e] |= mask
        else:
            row[s:] |= mask
            row[: e - seg_count] |= mask
        lam_out[i] = lam
    return lam_out


def _lane_components(
    start: np.ndarray, hops: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Label conflict components of same-lane arcs via a coverage sweep.

    Returns ``(comp_id, base, circular)``: per-arc component id, per-component
    base segment (run start, so local coords ``(seg - base) % n`` are
    contiguous), and whether the single run covers the entire ring (only then
    can local arcs wrap).
    """
    diff = np.zeros(n + 1, dtype=np.int64)
    end = start + hops
    wraps = end > n
    np.add.at(diff, start, 1)
    np.add.at(diff, np.where(wraps, n, end), -1)
    if wraps.any():
        diff[0] += int(wraps.sum())
        np.add.at(diff, end[wraps] - n, -1)
    covered = np.cumsum(diff[:n]) > 0
    if covered.all():
        return np.zeros(len(start), dtype=np.int64), np.zeros(1, dtype=np.int64), True
    prev = np.empty_like(covered)
    prev[0] = covered[-1]
    prev[1:] = covered[:-1]
    run_start = covered & ~prev
    ids = np.cumsum(run_start) - 1
    n_runs = int(ids[-1]) + 1
    # a run straddling the origin has its start late in the array; segments
    # before the first run_start belong to it (cumsum gave them id -1)
    ids = np.where(ids < 0, n_runs - 1, ids)
    bases = np.flatnonzero(run_start)
    return ids[start], bases, False


def _assign_arcs_component(
    lane: np.ndarray, start: np.ndarray, hops: np.ndarray,
    n: int, w: int, cache: dict,
) -> np.ndarray:
    """Component path of First Fit on raw arc arrays of ONE step.

    Processing order is longest-first with ties broken by row order — the
    reference greedy's order.  ``cache`` is the translated-component dedup
    table ``(circular, n, w, local starts, hops) -> assignment``; sharing
    one dict across many steps (the batched schedule builder does,
    DESIGN.md §10) — and even across ring sizes and wavelength budgets —
    is sound because the key fully determines the greedy's input.
    """
    t_count = lane.size
    order = np.argsort(-hops, kind="stable")  # longest-first, stable ties
    lam = np.empty(t_count, dtype=np.int64)

    # ---- component labeling per lane (the two fibers never interact) ----
    comp = np.empty(t_count, dtype=np.int64)
    base = np.empty(t_count, dtype=np.int64)
    circular_lane = [False, False]
    next_comp = 0
    for lane_id in (0, 1):
        sel = lane == lane_id
        if not sel.any():
            continue
        ids, bases, circ = _lane_components(start[sel], hops[sel], n)
        comp[sel] = ids + next_comp
        base[sel] = bases[ids]
        circular_lane[lane_id] = circ
        next_comp += len(bases)

    rel = (start - base) % n

    # ---- group arcs by component, preserving global processing order ----
    comp_in_order = comp[order]
    grouped = order[np.argsort(comp_in_order, kind="stable")]
    comp_sorted = comp[grouped]
    bounds = np.flatnonzero(np.r_[True, comp_sorted[1:] != comp_sorted[:-1]])
    bounds = np.append(bounds, t_count)

    # ---- dedupe translated components, solve one representative each ----
    for b, e in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        members = grouped[b:e]
        rs = rel[members]
        hp = hops[members]
        circ = circular_lane[int(lane[members[0]])]
        key = (circ, n, w, rs.tobytes(), hp.tobytes())
        sub = cache.get(key)
        if sub is None:
            seg_count = n if circ else int((rs + hp).max())
            sub = _solve_first_fit(rs.tolist(), hp.tolist(), w, seg_count, circ)
            cache[key] = sub
        lam[members] = sub
    return lam


def first_fit_assign(
    transfers, n: int, w: int, max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> TransferBatch:
    """Vectorized First Fit: bit-identical to the reference greedy.

    Accepts a :class:`TransferBatch` (or any ``Transfer`` sequence, coerced)
    and returns a new batch with wavelengths assigned.  Raises
    :exc:`WavelengthConflictError` iff the reference would.  When
    ``max_hops`` is given, arcs exceeding the insertion-loss hop budget are
    rejected with :exc:`InsertionLossError` before any assignment (such
    paths must be relayed via :func:`split_overlong_arcs` first).

    With a non-empty ``failures`` mask, routes touching a dead span or
    transceiver are rejected (:exc:`FailedResourceError` — the degraded
    builder must re-route before calling RWA) and the assignment honors
    per-node dead wavelengths via the forbidden-aware greedy.
    """
    batch = TransferBatch.coerce(transfers)
    t_count = len(batch)
    if t_count == 0:
        return batch
    if max_hops is not None:
        validate_hop_budget(batch, n, max_hops)
    if failures is not None and not failures.empty:
        validate_failures(batch, n, failures, check_wavelengths=False)
        if failures.dead_wavelengths:
            return _first_fit_forbidden(batch, n, w, failures)
    lane, start, hops = batch.arcs(n)

    if t_count <= 32:
        # tiny step: component machinery costs more than it saves
        order = np.argsort(-hops, kind="stable")
        lam = np.empty(t_count, dtype=np.int64)
        sel = order.tolist()
        st = [int(start[i]) for i in sel]
        hp = [int(hops[i]) for i in sel]
        ln = [int(lane[i]) for i in sel]
        for lane_id in (0, 1):
            idxs = [k for k, l in enumerate(ln) if l == lane_id]
            if not idxs:
                continue
            sub = _solve_first_fit(
                [st[k] for k in idxs], [hp[k] for k in idxs], w, n, True
            )
            for k, v in zip(idxs, sub.tolist()):
                lam[sel[k]] = v
        return batch.with_wavelengths(lam)

    lam = _assign_arcs_component(lane, start, hops, n, w, {})
    return batch.with_wavelengths(lam)


def first_fit_assign_concat(
    transfers, ptr, n: int, w: int,
    max_hops: int | None = None, cache: dict | None = None,
    failures: FailureMask | None = None,
) -> TransferBatch:
    """First-Fit RWA over concatenated independent steps (DESIGN.md §10).

    ``ptr`` is an int array ``[S+1]`` of offset pointers: rows
    ``[ptr[i], ptr[i+1])`` of ``transfers`` form step ``i``.  Each step is
    assigned independently — wavelength occupancy resets at every pointer
    boundary — so the result is bit-identical to calling
    :func:`first_fit_assign` on each slice (the ≤32-transfer fast path of
    the per-step entry point is a pure shortcut: both routes replay the
    reference greedy, enforced by ``tests/test_rwa_equivalence.py``).

    What the concatenation buys is *sharing*: the dedup table is one dict
    for all steps, and via ``cache`` it can be carried across calls — the
    batched multi-candidate schedule builder reuses one table across every
    candidate's relay sub-steps, and a broadcast step's components are the
    lane-mirrored image of its reduce step's, so the mirror assignments are
    cache hits.

    Memoization happens at two levels, both exploiting ring symmetries:

    * per step and lane, keyed on the translation-normalized arc multiset
      ``((start − start[0]) mod n, hops)`` — the ring is rotation-symmetric
      and its two fiber lanes are independent and interchangeable, so a
      translated (or lane-mirrored) step resolves without touching the
      greedy at all.  Relay chains are the big winner: every interior
      sub-step of a chain set is a translation of the first.
    * per conflict component inside an unseen step (the table
      ``first_fit_assign`` uses within one step).

    A non-empty ``failures`` mask disables both memo levels — per-node dead
    wavelengths break translation symmetry — and each step falls back to
    the forbidden-aware greedy (occupancy still resets at every pointer
    boundary).  Dead spans/transceivers on any route raise
    :exc:`FailedResourceError` up front.
    """
    batch = TransferBatch.coerce(transfers)
    ptr = np.asarray(ptr, dtype=np.int64)
    if ptr.size < 1 or ptr[0] != 0 or ptr[-1] != len(batch):
        raise ValueError("ptr must run from 0 to len(transfers)")
    if len(batch) == 0:
        return batch
    if max_hops is not None:
        validate_hop_budget(batch, n, max_hops)
    if failures is not None and not failures.empty:
        validate_failures(batch, n, failures, check_wavelengths=False)
        if failures.dead_wavelengths:
            lam = np.empty(len(batch), dtype=np.int64)
            for lo, hi in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
                if lo == hi:
                    continue
                sub = TransferBatch(
                    batch.src[lo:hi], batch.dst[lo:hi],
                    batch.direction[lo:hi], batch.bits[lo:hi],
                    batch.wavelength[lo:hi],
                )
                lam[lo:hi] = _first_fit_forbidden(sub, n, w,
                                                  failures).wavelength
            return batch.with_wavelengths(lam)
    lane, start, hops = batch.arcs(n)
    if cache is None:
        cache = {}
    lam = np.empty(len(batch), dtype=np.int64)
    zero_lane: dict[int, np.ndarray] = {}
    for lo, hi in zip(ptr[:-1].tolist(), ptr[1:].tolist()):
        if lo == hi:
            continue
        ln = lane[lo:hi]
        # the two fibers never interact and First Fit is per-lane greedy, so
        # assign each lane of the step on its own (order within a lane is
        # the global longest-first order restricted to it — identical)
        for lane_id in (0, 1):
            sel = np.flatnonzero(ln == lane_id)
            if sel.size == 0:
                continue
            st = start[lo:hi][sel]
            hp = hops[lo:hi][sel]
            rel = (st - st[0]) % n
            key = ("step", n, w, rel.tobytes(), hp.tobytes())
            sub = cache.get(key)
            if sub is None:
                zeros = zero_lane.get(sel.size)
                if zeros is None:
                    zeros = zero_lane[sel.size] = np.zeros(sel.size,
                                                           dtype=np.int64)
                sub = _assign_arcs_component(zeros, st, hp, n, w, cache)
                cache[key] = sub
            lam[lo + sel] = sub
    return batch.with_wavelengths(lam)


def validate_no_conflicts(
    transfers, n: int, w: int, max_hops: int | None = None,
    failures: FailureMask | None = None,
) -> None:
    """Check wavelength-conflict-freedom of an already-assigned step.

    Vectorized: expand every transfer into its directed segments, build
    ``(lane, segment, λ)`` keys, sort, and look for adjacent duplicates.
    With ``max_hops`` set, the insertion-loss hop budget is checked first
    (:exc:`InsertionLossError`); with a non-empty ``failures`` mask, any
    transfer touching a dead span/transceiver/λ is rejected
    (:exc:`FailedResourceError`).
    """
    batch = TransferBatch.coerce(transfers)
    if len(batch) == 0:
        return
    if max_hops is not None:
        validate_hop_budget(batch, n, max_hops)
    if failures is not None and not failures.empty:
        validate_failures(batch, n, failures)
    lam = batch.wavelength
    if (lam < 0).any():
        i = int(np.flatnonzero(lam < 0)[0])
        raise WavelengthConflictError(f"unassigned wavelength on {batch[i]}")
    if (lam >= w).any():
        i = int(np.flatnonzero(lam >= w)[0])
        raise WavelengthConflictError(
            f"wavelength {int(lam[i])} out of range (w={w})"
        )
    lane, start, hops = batch.arcs(n)
    total = int(hops.sum())
    if total == 0:
        return
    tid = np.repeat(np.arange(len(batch)), hops)
    first = np.cumsum(hops) - hops
    offs = np.arange(total) - first[tid]
    seg = (start[tid] + offs) % n
    key = (lane[tid] * n + seg) * (int(lam.max()) + 1) + lam[tid]
    order = np.argsort(key, kind="stable")
    ks = key[order]
    dup = np.flatnonzero(ks[1:] == ks[:-1])
    if dup.size:
        a, b = tid[order[dup[0]]], tid[order[dup[0] + 1]]
        ta, tb = batch[int(a)], batch[int(b)]
        raise WavelengthConflictError(
            f"conflict on dir={ta.direction} "
            f"segment={int(seg[order[dup[0]]])} lambda={ta.wavelength}: "
            f"{ta.src}->{ta.dst} vs {tb.src}->{tb.dst}"
        )


def validate_no_conflicts_reference(
    transfers: Sequence[Transfer], n: int, w: int
) -> None:
    """Original dict-based validator (oracle for the equivalence tests)."""
    occupancy: dict[tuple[int, int, int], Transfer] = {}
    for t in transfers:
        if t.wavelength < 0:
            raise WavelengthConflictError(f"unassigned wavelength on {t}")
        if t.wavelength >= w:
            raise WavelengthConflictError(
                f"wavelength {t.wavelength} out of range (w={w})"
            )
        for seg in path_segments(t.src, t.dst, n, t.direction):
            key = (t.direction, seg, t.wavelength)
            if key in occupancy:
                o = occupancy[key]
                raise WavelengthConflictError(
                    f"conflict on dir={t.direction} segment={seg} "
                    f"lambda={t.wavelength}: {o.src}->{o.dst} vs {t.src}->{t.dst}"
                )
            occupancy[key] = t


def wavelengths_used(transfers) -> int:
    if isinstance(transfers, TransferBatch):
        return 1 + transfers.max_wavelength
    return 0 if not transfers else 1 + max(t.wavelength for t in transfers)
