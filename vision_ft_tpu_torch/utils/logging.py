"""Tracker wiring (``vision_ft_tpu/utils/logging.py`` counterpart):
``TrackerConfig.loggers`` picks wandb and / or tensorboard; debug mode
disables tracking. A tracker whose package does not import (or whose run
cannot start) warns and logs nothing, as in the JAX package."""

from __future__ import annotations

import warnings
from typing import Any, Optional


class Trackers:
    """Multiplexer with an accelerate-tracker-like ``.log(dict, step)``."""

    def __init__(self, loggers: list[str], project_name: str, config: dict):
        self._backends: list[tuple[str, Any]] = []
        for name in loggers:
            if name not in ("wandb", "tensorboard"):
                raise ValueError(f"Unknown logger: {name}")
            try:
                if name == "wandb":
                    import wandb

                    self._backends.append(("wandb", wandb.init(project=project_name, config=config)))
                else:
                    from torch.utils.tensorboard import SummaryWriter

                    self._backends.append(
                        ("tensorboard", SummaryWriter(log_dir=f"runs/{project_name}")))
            except Exception as e:  # missing package / offline
                warnings.warn(f"{name} tracker unavailable: {e}")

    def log(self, values: dict, step: Optional[int] = None) -> None:
        for kind, backend in self._backends:
            if kind == "wandb":
                backend.log(values, step=step)
            else:
                for key, value in values.items():
                    if isinstance(value, (int, float)):
                        backend.add_scalar(key, value, global_step=step)

    def finish(self) -> None:
        for kind, backend in self._backends:
            if kind == "wandb":
                backend.finish()
            else:
                backend.close()


def get_trackers(config) -> list[str]:
    if config.trainer.debug_mode is not False:
        return []
    if config.tracker is not None:
        return config.tracker.loggers
    return []


def wandb_image(image, caption: Optional[str] = None):
    import wandb

    return wandb.Image(image, caption=caption)
