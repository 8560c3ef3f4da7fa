"""SDXL IP-Adapter training CLI, Kyara mode: cropped character references (``train/sdxl/ip_adapter.kyara.py``
counterpart), on the card:

    python3 -m vision_ft_tpu_torch.train.sdxl.ip_adapter_kyara --config configs/sdxl/ip_adapter.yml
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ...config import TrainConfig
from ...dataset.preview import TextToImagePreviewConfig
from ...dataset.kyara import KyaraDatasetConfig
from ...models.sdxl.train_ip_adapter import SDXLIPAdapterKyaraTraining
from ...trainer import Trainer


def build_trainer(config: TrainConfig, tokenizer=None, image_encoder=None, device=None) -> Trainer:
    """The Trainer with this mode's registrations; ``image_encoder``
    replaces the default SigLIP."""
    trainer = Trainer(config, device=device)
    trainer.register_train_dataset_class(KyaraDatasetConfig)
    trainer.register_preview_dataset_class(TextToImagePreviewConfig)
    trainer.register_model_class(SDXLIPAdapterKyaraTraining, tokenizer=tokenizer, image_encoder=image_encoder)
    return trainer


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args(argv)
    build_trainer(TrainConfig.from_config_file(args.config)).train()


if __name__ == "__main__":
    main()
