"""AdamW with a configurable state dtype and global-norm clipping: the port
of ``repro/optim/adamw.py``.

The math and dtypes are the reference's (f32 update math, moments stored in
``opt_state_dtype``, bias correction, decoupled weight decay).  The update
is written into the params and moments in place, one leaf at a time, which
keeps one leaf's temporaries in device memory instead of a second copy of
the state; the step count is a new tensor.  Leaves are visited in the
reference's order (``repro_torch.tree``), so the global norm sums in the
same leaf order.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import leaves, map_tensors, parts


def global_norm(tree) -> torch.Tensor:
    total = None
    for leaf in leaves(tree):
        s = sum(torch.sum(torch.square(p.float())) for p in parts(leaf))
        total = s if total is None else total + s
    return torch.sqrt(total)


def adamw_init(params, state_dtype=torch.float32) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)  # noqa: E731
    return {
        "m": map_tensors(zeros, params),
        "v": map_tensors(zeros, params),
        "count": torch.zeros((), dtype=torch.int32),
    }


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, lr: torch.Tensor, tc: TrainConfig):
    """Returns (params, opt_state, metrics): ``params`` and the moments are
    the given tensors, updated in place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt_state["count"] + 1
    b1, b2 = tc.b1, tc.b2
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count.float()
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count.float()
    dev = parts(leaves(params)[0])[0].device
    scale, c1, c2, lr_ = (torch.as_tensor(t).to(dev) for t in (scale, bc1, bc2, lr))

    def upd(p, g, m, v):
        g = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * g
        v_new = b2 * v.float() + (1 - b2) * g * g
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + 1e-8) + tc.weight_decay * p.float()
        p.copy_(p.float() - lr_ * step)
        m.copy_(m_new)
        v.copy_(v_new)

    map_tensors(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": count}, {"grad_norm": gnorm}
