"""SDXL RoPE distillation training CLI (``train/sdxl/rope_distill.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.rope_distill --config configs/sdxl/rope_distill.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.train_rope_distill import SDXLForRoPEDistillTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, device=None) -> Trainer:
    """The Trainer with the SDXL RoPE-distillation registrations."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLForRoPEDistillTraining, tokenizer=tokenizer)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
