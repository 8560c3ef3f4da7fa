"""SDXL text-to-image training CLI (``train/sdxl/text_to_image.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.text_to_image --config configs/sdxl/xxx.yml

``VFT_FLASH_SHORTK=1`` sends the UNet's cross-attention through the
short-K kernels (``ops.flash_attention.set_flash_shortk``), as the same
variable does in the JAX package.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.train_text_to_image import SDXLForTextToImageTraining
from ...ops.flash_attention import set_flash_shortk
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, device=None) -> Trainer:
    """The Trainer with the SDXL text-to-image registrations."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLForTextToImageTraining, tokenizer=tokenizer)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    set_flash_shortk(os.environ.get("VFT_FLASH_SHORTK", "0") == "1")
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
