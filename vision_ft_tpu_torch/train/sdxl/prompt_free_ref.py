"""SDXL prompt-free generation training CLI, reference-image mode: pairs from a metadata parquet (``train/sdxl/prompt_free.ref.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.prompt_free_ref --config configs/sdxl/prompt_free.ref.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.referenced_text_to_image import ReferencedTextToImageDatasetConfig
from ...models.sdxl.train_prompt_free import SDXLPFGTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, image_encoder=None, device=None) -> Trainer:
    """The Trainer with this workload's registrations; ``image_encoder``
    replaces the default timm encoder."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(ReferencedTextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLPFGTraining, tokenizer=tokenizer, image_encoder=image_encoder)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
