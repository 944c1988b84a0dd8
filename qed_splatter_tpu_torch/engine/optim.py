"""Per-parameter-group Adam with exponential-decay schedules (port of
``engine/optim.py``).

One Adam (b1 0.9, b2 0.999, the group's eps) per group, each with the
schedule of its :class:`~qed_splatter_tpu_torch.configs.AdamConfig`. The
update is optax's ``chain(scale_by_adam(b1, b2, eps),
scale_by_learning_rate(schedule))`` written out:

- mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu;
- bias correction by the group's own count after the increment;
- update = -schedule(count before the increment) * mu_hat / (sqrt(nu_hat) + eps).

A group's state is a plain dict ``{"count", "mu", "nu"}`` (count an int32
0-d tensor), so densification can reset the moments of re-seeded slots in
place. Updates are in place: the parameter, its moments and the count are
modified, and no call builds a tensor from a host value, so the update can
be captured in a CUDA graph and replayed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from qed_splatter_tpu_torch.configs import AdamConfig

B1 = 0.9
B2 = 0.999
F32 = torch.float32


def make_schedule(cfg: AdamConfig) -> Callable[[object], torch.Tensor]:
    """nerfstudio's ExponentialDecayScheduler, in float32: a sine ramp from
    ``lr_pre_warmup`` to ``lr`` over ``warmup_steps``, then log-linear decay
    from ``lr`` to ``lr_final`` by ``max_steps``; constant ``lr`` when
    ``lr_final`` is None. Takes an int or a tensor step."""
    lr_init = cfg.lr
    lr_final = cfg.lr_final if cfg.lr_final is not None else cfg.lr

    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(F32)
        dev = step.device
        if cfg.warmup_steps > 0:
            frac = torch.clamp(step / cfg.warmup_steps, 0.0, 1.0)
            warm = cfg.lr_pre_warmup + (lr_init - cfg.lr_pre_warmup) * (
                torch.sin(0.5 * math.pi * frac))
        else:
            warm = torch.full((), lr_init, dtype=F32, device=dev)
        if lr_final == lr_init:
            decayed = torch.full((), lr_init, dtype=F32, device=dev)
        else:
            t = torch.clamp(
                (step - cfg.warmup_steps)
                / max(cfg.max_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            log_a = torch.log(torch.full((), lr_init, dtype=F32, device=dev))
            log_b = torch.log(torch.full((), lr_final, dtype=F32, device=dev))
            decayed = torch.exp((1.0 - t) * log_a + t * log_b)
        return torch.where(step < cfg.warmup_steps, warm, decayed)

    return schedule


def adam_init(param: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {
        "count": torch.zeros((), dtype=torch.int32, device=param.device),
        "mu": torch.zeros_like(param),
        "nu": torch.zeros_like(param),
    }


@torch.no_grad()
def adam_update(grad: torch.Tensor, state: Dict, cfg: AdamConfig,
                schedule: Callable) -> torch.Tensor:
    """One Adam step of one group: updates ``state`` in place (the count
    too: a graph replay reads the count it incremented) and returns the
    parameter update (optax's ``updates``)."""
    count = state["count"]
    lr = schedule(count)                 # read before the increment
    count.add_(1)
    mu = state["mu"].mul_(B1).add_((1.0 - B1) * grad)
    nu = state["nu"].mul_(B2).add_((1.0 - B2) * (grad * grad))
    c = count.to(F32)
    bc1 = 1.0 - torch.pow(torch.full((), B1, dtype=F32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.full((), B2, dtype=F32, device=c.device), c)
    return (-lr) * ((mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps))


@torch.no_grad()
def adam_update_(param: torch.Tensor, grad: torch.Tensor, state: Dict,
                 cfg: AdamConfig, schedule: Callable) -> None:
    """:func:`adam_update` applied to ``param`` in place."""
    param.add_(adam_update(grad, state, cfg, schedule))


class GroupOptimizers:
    """Independent Adams keyed by parameter-group name."""

    def __init__(self, configs: Dict[str, AdamConfig]):
        self.configs = dict(configs)
        self.schedules = {k: make_schedule(v) for k, v in self.configs.items()}

    def init(self, params: Dict[str, torch.Tensor]) -> Dict:
        return {k: adam_init(v) for k, v in params.items()}

    def update_group(self, name: str, param: torch.Tensor,
                     grad: torch.Tensor, state: Dict) -> None:
        adam_update_(param, grad, state, self.configs[name],
                     self.schedules[name])

    def update(self, grads: Dict, state: Dict, params: Dict) -> None:
        """Every group of ``grads``, in place on ``params`` and ``state``."""
        for k, g in grads.items():
            self.update_group(k, params[k], g, state[k])
