"""SDXL DRaFT+ reward training CLI: LoRA trained on a differentiable reward (``train/sdxl/draft_plus.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.draft_plus --config configs/sdxl/draft_plus.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.train_draft_plus import SDXLForDRaFTPlusTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, reward_models=None, device=None) -> Trainer:
    """The Trainer with this workload's registrations; ``reward_models``
    replace the ones the config names."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLForDRaFTPlusTraining, tokenizer=tokenizer, reward_models=reward_models)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
