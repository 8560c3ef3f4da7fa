"""Local-file preview callback (``vision_ft_tpu/preview/local.py`` counterpart)."""

from __future__ import annotations

from typing import Optional, Union

from PIL import Image

from .util import PreviewCallback, PreviewCallbackConfig


class LocalPreviewCallbackConfig(PreviewCallbackConfig):
    type: str = "local"


class LocalPreviewCallback(PreviewCallback):
    def preview_image(
        self,
        images: list[Image.Image],
        epoch: int,
        steps: int,
        id: Union[str, int],
        metadata: Optional[dict] = None,
    ):
        total_images = len(images)
        for i, image in enumerate(images):
            image_id = f"{id}-{i:0={total_images}}" if total_images > 1 else id
            image_path = self.save_dir / self.format_template(
                epoch=epoch, steps=steps, id=image_id
            )
            image_path.parent.mkdir(parents=True, exist_ok=True)
            image.save(image_path)
