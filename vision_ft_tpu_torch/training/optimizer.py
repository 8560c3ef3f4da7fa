"""Optimizer factory (``vision_ft_tpu/training/optimizer.py`` counterpart).

The same config strings resolve to ``torch.optim`` optimizers that take,
step for step, the updates of the optax transformations the JAX package
builds:

  torch.optim.AdamW   -> torch.optim.AdamW   (optax.adamw)
  torch.optim.Adam    -> torch.optim.Adam    (optax.adam)
  torch.optim.SGD     -> torch.optim.SGD     (optax.sgd)
  torch.optim.RMSprop -> RMSpropEpsInSqrt    (optax.rmsprop, whose eps sits
                         inside the square root, unlike torch's RMSprop)

:func:`get_optimizer` returns an :class:`Optimizer`: the recipe (name,
learning rate or schedule, clipping) from which ``init`` builds the
``torch.optim`` object for a set of parameters and ``update_`` applies one
step. Clipping is optax's: by value first, then by global norm with the
factor ``max_norm / norm`` applied only when ``norm >= max_norm`` (torch's
``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).

Not ported, each raising ``NotImplementedError`` by name: the 8-bit AdamW
(``bitsandbytes.optim.AdamW8bit`` / ``Adam8bit``), the schedule-free
optimizers with ``eval_params``, Adafactor and the ``optax.<name>``
passthrough.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import torch

ScheduleOrFloat = float | Callable[[int], float]


class RMSpropEpsInSqrt(torch.optim.Optimizer):
    """RMSprop as optax.rmsprop computes it: nu = decay nu + (1 - decay) g^2,
    u = lr g / sqrt(nu + eps), then momentum on the scaled update
    (buf = momentum buf + u, p -= buf): eps sits inside the square root and
    the learning rate is applied before the momentum, unlike torch's RMSprop."""

    def __init__(self, params, lr: float, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["buf"] = torch.zeros_like(p)
                nu, buf = state["nu"], state["buf"]
                nu.mul_(group["alpha"]).addcmul_(p.grad, p.grad, value=1 - group["alpha"])
                buf.mul_(group["momentum"]).add_(
                    p.grad * torch.rsqrt(nu + group["eps"]), alpha=group["lr"]
                )
                p.sub_(buf)


def _betas(args: dict) -> tuple[float, float]:
    return tuple(args.get("betas", (0.9, 0.999)))


def _adamw(params, lr, args):
    return torch.optim.AdamW(
        params, lr=lr, betas=_betas(args), eps=args.get("eps", 1e-8),
        weight_decay=args.get("weight_decay", 0.01),
    )


def _adam(params, lr, args):
    return torch.optim.Adam(params, lr=lr, betas=_betas(args), eps=args.get("eps", 1e-8))


def _sgd(params, lr, args):
    return torch.optim.SGD(
        params, lr=lr, momentum=args.get("momentum") or 0.0, nesterov=args.get("nesterov", False)
    )


def _rmsprop(params, lr, args):
    return RMSpropEpsInSqrt(
        params, lr=lr, alpha=args.get("alpha", 0.99), eps=args.get("eps", 1e-8),
        momentum=args.get("momentum", 0.0),
    )


_REGISTRY = {
    "torch.optim.adamw": _adamw,
    "adamw": _adamw,
    "torch.optim.adam": _adam,
    "adam": _adam,
    "torch.optim.sgd": _sgd,
    "sgd": _sgd,
    "torch.optim.rmsprop": _rmsprop,
}
_NOT_PORTED = {
    "torch.optim.adafactor": "Adafactor",
    "adafactor": "Adafactor",
    "bitsandbytes.optim.adamw8bit": "adamw_8bit (the blockwise int8-state AdamW)",
    "bitsandbytes.optim.adam8bit": "adamw_8bit (the blockwise int8-state AdamW)",
}


def is_schedule_free(name: str) -> bool:
    return "schedulefree" in name.lower().replace("_", "")


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32 (optax.global_norm);
    one fused pass over the list, not three launches a tensor."""
    grads = list(grads)
    if not grads:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An optimizer recipe: what ``get_optimizer`` resolved."""

    name: str
    learning_rate: ScheduleOrFloat
    factory: Callable
    args: dict
    max_grad_norm: Optional[float] = None
    max_grad_value: Optional[float] = None

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        return self.factory(list(params), self.lr_at(0), self.args)

    @torch.no_grad()
    def clip_(self, grads: Sequence[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """Clip in place: by value, then by global norm (optax's chain).
        ``norm`` is the global norm of ``grads`` where the caller has it
        already; it is computed here after a clip by value."""
        grads = list(grads)
        if self.max_grad_value is not None:
            torch._foreach_clamp_min_(grads, -self.max_grad_value)
            torch._foreach_clamp_max_(grads, self.max_grad_value)
            norm = None
        if self.max_grad_norm is not None:
            if norm is None:
                norm = global_norm(grads)
            # optax.clip_by_global_norm: untouched below max_norm, else
            # (g / norm) * max_norm; one factor, no host synchronization
            factor = torch.where(norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm)
            torch._foreach_mul_(grads, factor)

    @torch.no_grad()
    def update_(
        self,
        opt_state: torch.optim.Optimizer,
        params: Sequence[torch.nn.Parameter],
        grads: Sequence[torch.Tensor],
        count: int,
        norm: Optional[torch.Tensor] = None,
    ) -> None:
        """One update in place: clip ``grads`` (consumed; ``norm`` is their
        global norm where the caller has it), read the schedule at ``count``
        (0 for the first update) and step."""
        self.clip_(grads, norm)
        lr = self.lr_at(count)
        for group in opt_state.param_groups:
            group["lr"] = lr
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        opt_state.step()
        for p in params:
            p.grad = None


def get_optimizer(
    name: str,
    lr: ScheduleOrFloat,
    args: Optional[dict] = None,
    max_grad_norm: Optional[float] = None,
    max_grad_value: Optional[float] = None,
) -> Optimizer:
    """Resolve an optimizer string to an :class:`Optimizer` recipe, with the
    clipping hooks folded in."""
    args = dict(args or {})
    key = name.lower()
    if is_schedule_free(key):
        raise NotImplementedError(f"schedule-free optimizers ({name}) and eval_params are not ported")
    if key in _NOT_PORTED:
        raise NotImplementedError(f"{_NOT_PORTED[key]} ({name}) is not ported")
    if key.startswith("optax."):
        raise NotImplementedError(f"the optax passthrough ({name}) has no counterpart in the port")
    if key not in _REGISTRY:
        raise ValueError(f"Unknown optimizer: {name!r}")
    return Optimizer(name, lr, _REGISTRY[key], args, max_grad_norm, max_grad_value)


def eval_params(name: str, opt_state, params):
    """Evaluation parameters: the parameters themselves for every ported
    optimizer (the schedule-free ones, which transform them, are not)."""
    if is_schedule_free(name):
        raise NotImplementedError("eval_params of schedule-free optimizers is not ported")
    return params
