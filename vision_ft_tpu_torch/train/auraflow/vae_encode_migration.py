"""AuraFlow VAE-encoder migration training CLI (``train/auraflow/vae_encode_migration.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.auraflow.vae_encode_migration --config configs/auraflow/xxx.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.auraflow.train_vae_encode_migration import AuraFlowForVAEEncoderMigrationTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, device=None) -> Trainer:
    """The Trainer with the AuraFlow VAE-encoder migration registrations."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(AuraFlowForVAEEncoderMigrationTraining, tokenizer=tokenizer)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
