"""(``vision_ft_tpu/modules/reward/functional.py`` counterpart)."""

from __future__ import annotations

from .utils import RewardModelConfig, RewardModelMixin


def load_reward_models(configs: list[RewardModelConfig], device=None) -> list[RewardModelMixin]:
    return [config.load_model(device=device) for config in configs]
