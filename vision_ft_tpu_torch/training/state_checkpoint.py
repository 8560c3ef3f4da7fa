"""Full train-state checkpoints (``vision_ft_tpu/training/state_checkpoint.py``
counterpart).

The Trainer persists {step, trainable parameters, optimizer state, EMA}
every ``trainer.state_checkpoint_every_steps`` under
``<state_checkpoint_dir>/step_<N>/state.pt`` and, with
``resume_from_state_checkpoint``, restores the newest one before training.
The file is written by ``torch.save`` to a temporary name and renamed into
place, so a step directory holds either a whole state or none; it is read
back with ``torch.load(weights_only=True)``. The optimizers of
``training/optimizer.py`` that keep state of their own (the 8-bit AdamW's
int8 codes and fp32 scales, Adafactor's factored moments, the
schedule-free iterates and counters) restore it in its dtypes, so a resumed
run continues bit for bit. Older step directories are
kept (pruning is the operator's call). The two packages' files are not
interchangeable: the JAX package writes Orbax trees.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping, Optional

import torch

_FILE = "state.pt"


def _step_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_train_state(
    directory: str, step: int, trainable: Mapping[str, torch.Tensor], opt_state: Any,
    ema: Optional[Mapping[str, torch.Tensor]] = None,
) -> str:
    """Write the state under ``<directory>/step_<step>``; returns that path.
    ``opt_state`` is any tree ``torch.save`` takes with ``weights_only``
    reading (the Trainer passes the optimizer's ``state_dict()`` and its
    update count)."""
    path = _step_path(directory, step)
    os.makedirs(path, exist_ok=True)
    state = {
        "step": step,
        "trainable": {k: v.detach() for k, v in trainable.items()},
        "opt_state": opt_state,
    }
    if ema is not None:
        state["ema"] = dict(ema)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_checkpoint_step(directory: str) -> Optional[int]:
    """The largest N of the ``step_<N>`` directories that hold a whole
    state, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.isfile(os.path.join(directory, name, _FILE)):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_train_state(
    directory: str, device: Optional[torch.device | str] = None, with_ema: bool = False,
) -> Optional[tuple]:
    """The newest ``step_<N>`` state read onto ``device`` (default: where it
    was saved), or None when there is none: ``(step, trainable, opt_state)``,
    or with ``with_ema`` ``(step, trainable, opt_state, ema)``. A state
    written before EMA was configured has no ``ema``: a warning is logged
    and the EMA is seeded from the restored trainable parameters (fp32
    copies)."""
    step = latest_checkpoint_step(directory)
    if step is None:
        return None
    path = _step_path(directory, step)
    state = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    out = (int(state["step"]), state["trainable"], state["opt_state"])
    if not with_ema:
        return out
    ema = state.get("ema")
    if ema is None:
        # loudly: the running average is replaced by the instantaneous weights
        logging.getLogger(__name__).warning(
            "restore_train_state: no 'ema' in %s; seeding the EMA from the restored "
            "trainable parameters", path,
        )
        ema = {k: v.to(torch.float32, copy=True) for k, v in state["trainable"].items()}
    return (*out, ema)
