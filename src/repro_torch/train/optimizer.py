"""AdamW with global-norm clipping: the twin of ``repro.train.optimizer``
(meshless).

Plain functions over the parameter tree, not ``torch.optim.AdamW``,
which puts ``eps`` and the bias correction in another order and decays
the parameter before the step.  ``AdamWState`` has the reference's
fields, so a checkpoint's ``opt/step``, ``opt/mu/...`` and
``opt/nu/...`` names match.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Zero moments in float32 beside each parameter, step 0."""
    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(z, params), nu=tree_map(z, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, in float32, summed
    leaf by leaf in the tree's (sorted-key) order."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


@torch.no_grad()
def update(grads, state: AdamWState, params, lr: float = 3e-4,
           b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
           weight_decay: float = 0.1, grad_clip: float = 1.0):
    """Returns (new_params, new_state).  Global-norm clipping + AdamW."""
    gnorm = global_norm(grads)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    # the bias corrections as float32 powers, as jnp computes them
    f32 = dict(dtype=torch.float32, device=step.device)
    c1 = 1.0 - torch.pow(torch.tensor(b1, **f32), step.float())
    c2 = 1.0 - torch.pow(torch.tensor(b2, **f32), step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / c1
        vhat = v / c2
        pf = p.float()
        new_p = pf - lr * (mhat / (torch.sqrt(vhat) + eps)
                           + weight_decay * pf)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda p, o: o[i], params, out)  # noqa: E731
    return pick(0), AdamWState(step=step, mu=pick(1), nu=pick(2))
