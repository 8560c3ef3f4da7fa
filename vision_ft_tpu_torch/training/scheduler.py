"""LR-schedule factory (``vision_ft_tpu/training/scheduler.py``
counterpart).

The same names map to ``step -> lr`` callables that return a Python float
with the values of the optax schedules the JAX package builds (linear,
polynomial, cosine and their joins, written out here). The step is the
count of updates made so far: 0 for the first update.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

Schedule = Callable[[int], float]


def _constant(value: float) -> Schedule:
    return lambda step: float(value)


def _polynomial(init: float, end: float, power: float, transition_steps: int) -> Schedule:
    """optax.polynomial_schedule: (init - end) * (1 - t/T)**power + end."""
    if transition_steps <= 0:
        return _constant(init)

    def schedule(step):
        count = min(max(step, 0), transition_steps)
        return (init - end) * (1 - count / transition_steps) ** power + end

    return schedule


def _linear(init: float, end: float, transition_steps: int) -> Schedule:
    return _polynomial(init, end, 1, transition_steps)


def _cosine_decay(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got {decay_steps}.")

    def schedule(step):
        count = min(step, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each schedule counts from its boundary."""

    def schedule(step):
        output = schedules[0](step)
        for boundary, later in zip(boundaries, schedules[1:]):
            if step >= boundary:
                output = later(step - boundary)
        return output

    return schedule


def get_schedule(
    name: Optional[str],
    base_lr: float,
    num_training_steps: int = 0,
    num_warmup_steps: int = 0,
    args: Optional[dict] = None,
) -> Schedule:
    """Return a ``step -> lr`` callable. ``name=None`` -> constant."""
    args = args or {}
    num_warmup_steps = int(args.get("num_warmup_steps", num_warmup_steps))
    num_training_steps = int(args.get("num_training_steps", num_training_steps))
    warmup = _linear(0.0, base_lr, max(num_warmup_steps, 1))
    if name is None or name in ("nothing", "constant"):
        return _constant(base_lr)
    if name == "constant_with_warmup":
        return _join([warmup, _constant(base_lr)], [num_warmup_steps])
    if name == "linear":
        decay = max(num_training_steps - num_warmup_steps, 1)
        return _join([warmup, _linear(base_lr, 0.0, decay)], [num_warmup_steps])
    if name == "cosine":
        # optax.warmup_cosine_decay_schedule(0, base_lr, warmup, total)
        warmup_steps = max(num_warmup_steps, 1)
        total = max(num_training_steps, num_warmup_steps + 1)
        return _join(
            [_linear(0.0, base_lr, warmup_steps), _cosine_decay(base_lr, total - warmup_steps)],
            [warmup_steps],
        )
    if name == "cosine_with_restarts":
        cycles = int(args.get("num_cycles", 1))
        per = max((num_training_steps - num_warmup_steps) // max(cycles, 1), 1)
        scheds = [warmup]
        bounds = [num_warmup_steps]
        for i in range(cycles):
            scheds.append(_cosine_decay(base_lr, per))
            if i < cycles - 1:
                bounds.append(num_warmup_steps + per * (i + 1))
        return _join(scheds, bounds)
    if name == "polynomial":
        power = float(args.get("power", 1.0))
        lr_end = float(args.get("lr_end", 1e-7))
        decay = max(num_training_steps - num_warmup_steps, 1)
        return _join([warmup, _polynomial(base_lr, lr_end, power, decay)], [num_warmup_steps])
    if name == "inverse_sqrt":
        warm = max(num_warmup_steps, 1)
        return lambda step: base_lr * min((step + 1) / warm, math.sqrt(warm / max(step + 1, 1)))
    raise ValueError(f"Unknown scheduler: {name!r}")
