"""SDXL flow-match conversion training CLI (``train/sdxl/flow_match.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.flow_match --config configs/sdxl/flow_match.yml

(also ``configs/sdxl/flow_match_x0.yml``, the image-prediction variant).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.text_to_image import TextToImageDatasetConfig
from ...models.sdxl.train_flow_match import SDXLForFlowMatchingTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, device=None) -> Trainer:
    """The Trainer with the SDXL flow-match registrations."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(TextToImageDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLForFlowMatchingTraining, tokenizer=tokenizer)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
