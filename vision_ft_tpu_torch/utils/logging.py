"""Tracker wiring (``vision_ft_tpu/utils/logging.py`` counterpart):
``TrackerConfig.loggers`` picks the trackers; debug mode disables
tracking. wandb and tensorboard are not ported: configuring either raises
``NotImplementedError``. With no tracker configured the Trainer logs to
nothing, as the JAX package does."""

from __future__ import annotations

from typing import Optional


class Trackers:
    """Multiplexer with an accelerate-tracker-like ``.log(dict, step)``."""

    def __init__(self, loggers: list[str], project_name: str, config: dict):
        for name in loggers:
            if name in ("wandb", "tensorboard"):
                raise NotImplementedError(f"the {name} tracker is not ported")
            raise ValueError(f"Unknown logger: {name}")
        self.project_name = project_name

    def log(self, values: dict, step: Optional[int] = None) -> None:
        pass

    def finish(self) -> None:
        pass


def get_trackers(config) -> list[str]:
    if config.trainer.debug_mode is not False:
        return []
    if config.tracker is not None:
        return config.tracker.loggers
    return []
