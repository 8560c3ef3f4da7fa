"""SDXL prompt-free generation training CLI, self-reference mode: the target image is its own reference (``train/sdxl/prompt_free.self.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.prompt_free_self --config configs/sdxl/prompt_free.self.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.train_prompt_free import SDXLPFGSelfTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, image_encoder=None, device=None) -> Trainer:
    """The Trainer with this workload's registrations; ``image_encoder``
    replaces the default timm encoder."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLPFGSelfTraining, tokenizer=tokenizer, image_encoder=image_encoder)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
