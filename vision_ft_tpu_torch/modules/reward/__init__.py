from .functional import load_reward_models
from .pickscore import PickScoreConfig, PickScoreRewardModel
from .utils import RewardModelConfig, RewardModelMixin

__all__ = [
    "load_reward_models",
    "PickScoreConfig",
    "PickScoreRewardModel",
    "RewardModelConfig",
    "RewardModelMixin",
]
