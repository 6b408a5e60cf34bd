"""Closed-form step counts and communication-time models (Table I, Eq. 1).

Step counts (paper Sec. III-D, Table I):

    Ring    2(N-1)
    H-Ring  2(g²+N)/g + ⌈g/w⌉ - 4          (paper [13]; see note below)
    BT      2⌈log₂N⌉  (or 2(⌈log₂N⌉+1))
    WRHT    2⌈log_m N⌉  or  2⌈log_m N⌉ - 1

NOTE on H-Ring: the paper's Table I prints 411 for (N=1000, g=5, w=64) which
equals ``2(g²+N)/g + ⌈g/w⌉`` — the ``-4`` of their own formula is not applied
in the table.  We implement the formula as printed in the text and expose the
table variant too; the benchmark reports both.

Time model: Eq. (1): ``T = θ·d/B + θ·a`` for algorithms whose every step
carries the full vector ``d`` (WRHT, BT).  Chunked ring-style algorithms carry
``d/N`` (or ``d/g``) per step; the per-algorithm functions below spell out the
byte terms explicitly so each matches its transfer schedule.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .topology import PhysicalParams


def ring_steps(n: int) -> int:
    return 2 * (n - 1)


def hring_steps(n: int, g: int, w: int, table_variant: bool = False) -> int:
    base = 2 * (g * g + n) / g + math.ceil(g / w)
    return math.ceil(base) if table_variant else math.ceil(base) - 4


def bt_steps(n: int, plus_one: bool = False) -> int:
    l = math.ceil(math.log2(n))
    return 2 * (l + 1) if plus_one else 2 * l


def rd_steps(n: int) -> int:
    """Recursive doubling all-reduce: ⌈log₂N⌉ full-vector exchange steps."""
    return math.ceil(math.log2(n))


def wrht_steps(n: int, m: int, with_alltoall: bool = True) -> int:
    if n <= 1:
        return 0
    l = max(1, math.ceil(math.log(n, m)))
    return 2 * l - 1 if with_alltoall else 2 * l


@dataclass(frozen=True)
class OpticalParams:
    """Table II, optical side, plus the physical-layer / timing knobs.

    ``physical`` enables the insertion-loss constraint (Sec. III): schedules
    are built under the hop budget ``physical.max_hops`` and the simulator
    adds per-hop propagation delay.  ``timing`` selects the simulator
    engine: ``"lockstep"`` (per-step max, the golden upper bound),
    ``"event"`` (per-transfer finish times, global step barrier — equals
    lockstep by construction) or ``"overlap"`` (SWOT-style: a node retunes
    its MRRs for the next step while other nodes' tail transfers of the
    current step are still in flight).
    """

    bandwidth_bps: float = 40e9     # per wavelength
    reconfig_delay_s: float = 25e-6  # MRR reconfiguration per step (the α term)
    wavelengths: int = 64
    physical: PhysicalParams | None = None
    timing: str = "lockstep"

    @staticmethod
    def from_cost(alpha_s: float, link_bw_Bps: float, links: int,
                  physical: PhysicalParams | None = None,
                  timing: str = "lockstep") -> "OpticalParams":
        """Map the planner's α–β ``CostParams`` onto the optical simulator.

        The α term is the per-step MRR reconfiguration delay, the per-link
        byte rate becomes the per-wavelength bit rate, and the ``links``
        concurrent channels split across the two fiber directions
        (``CostParams.optical(w)`` uses ``links = 2w``, so this mapping is
        its exact inverse).  Lets ``planner.plan_bucket(backend="simulated")``
        cost the same candidate schedules with the flit-level simulator
        instead of the closed forms.
        """
        return OpticalParams(
            bandwidth_bps=link_bw_Bps * 8,
            reconfig_delay_s=alpha_s,
            wavelengths=max(1, links // 2),
            physical=physical,
            timing=timing,
        )


def max_feasible_m(p: OpticalParams) -> int:
    """Largest WRHT group size under both Lemma 1 and the insertion-loss
    fan-out cap (``2·max_hops + 1``, see ``PhysicalParams.fan_out_cap``)."""
    m = 2 * p.wavelengths + 1
    if p.physical is not None:
        m = min(m, p.physical.fan_out_cap)
    return m


@dataclass(frozen=True)
class ElectricalParams:
    """Table II, electrical side (fat-tree)."""

    bandwidth_bps: float = 25e9
    router_delay_s: float = 50e-6
    radix: int = 32                  # 32-port routers, two-level clos


# ---------------------------------------------------------------------------
# Analytic communication times on the OPTICAL ring (used by fig4 benchmark
# alongside the event simulator; the simulator adds flit/O-E-O effects).
# ---------------------------------------------------------------------------

def t_wrht(n: int, d_bits: float, p: OpticalParams, m: int | None = None,
           with_alltoall: bool = False) -> float:
    """Eq. (1): every step moves the full vector d.  The default group size
    honours the insertion-loss fan-out cap when ``p.physical`` is set."""
    m = m if m is not None else max_feasible_m(p)
    theta = wrht_steps(n, m, with_alltoall)
    return theta * d_bits / p.bandwidth_bps + theta * p.reconfig_delay_s


def t_ring_optical(n: int, d_bits: float, p: OpticalParams) -> float:
    """Bandwidth-optimal ring: 2(N-1) steps of d/N on neighbour segments."""
    theta = ring_steps(n)
    return theta * (d_bits / n) / p.bandwidth_bps + theta * p.reconfig_delay_s


def t_bt_optical(n: int, d_bits: float, p: OpticalParams) -> float:
    """Binary tree: every step moves the full vector d."""
    theta = bt_steps(n)
    return theta * d_bits / p.bandwidth_bps + theta * p.reconfig_delay_s


def t_hring_optical(n: int, d_bits: float, p: OpticalParams, g: int = 5) -> float:
    """Hierarchical ring [13]: intra-group ring (chunks d/g) + inter-group
    ring among N/g representatives (chunks d/(N/g)) + intra all-gather.
    Step count follows the paper's formula; byte term from the decomposition.
    """
    n_groups = max(1, n // g)
    theta = hring_steps(n, g, p.wavelengths)
    intra_steps = 2 * (g - 1)
    inter_steps = 2 * (n_groups - 1)
    bytes_term = (
        intra_steps * (d_bits / g) + inter_steps * (d_bits / max(1, n_groups))
    ) / p.bandwidth_bps
    return bytes_term + theta * p.reconfig_delay_s


# ---------------------------------------------------------------------------
# Electrical fat-tree (fig5): E-Ring and Recursive Doubling, SimGrid-style
# analytic latency = routers-on-path × router_delay + serialization.
# ---------------------------------------------------------------------------

def _fattree_hops(src: int, dst: int, p: ElectricalParams) -> int:
    """Routers traversed in a two-level fat-tree of 32-port edge routers."""
    if src == dst:
        return 0
    return 1 if src // p.radix == dst // p.radix else 3  # edge / edge-core-edge


def t_ring_electrical(n: int, d_bits: float, p: ElectricalParams) -> float:
    """E-Ring: 2(N-1) steps; neighbour (i, i+1) is same-edge except at
    32-node boundaries — per-step latency is the max over concurrent sends,
    which includes one boundary pair (3 router hops) whenever n > radix."""
    theta = ring_steps(n)
    hops = 3 if n > p.radix else 1
    per_step = (d_bits / n) / p.bandwidth_bps + hops * p.router_delay_s
    return theta * per_step


def t_rd_electrical(n: int, d_bits: float, p: ElectricalParams) -> float:
    """Recursive doubling: ⌈log₂N⌉ steps of full-vector pairwise exchange;
    partners at distance 2^i cross the core once 2^i >= radix."""
    total = 0.0
    for i in range(rd_steps(n)):
        hops = 1 if 2**i < p.radix else 3
        total += d_bits / p.bandwidth_bps + hops * p.router_delay_s
    return total


# Convenience: the four DNN models used in the paper's evaluation, gradient
# payload in bits (fp32 parameters, Sec. IV-A).
PAPER_MODELS_BITS: dict[str, float] = {
    "AlexNet": 62.3e6 * 32,
    "VGG16": 138e6 * 32,
    "ResNet50": 25e6 * 32,
    "GoogLeNet": 6.7977e6 * 32,
}
