"""Video writing (``vision_ft_tpu/utils/video.py`` counterpart): frames to
an mp4 file through OpenCV's ``VideoWriter`` with the mp4v codec, imported
at the call."""

from __future__ import annotations

import tempfile

import numpy as np
from PIL import Image


def write_images_as_video(images: list[Image.Image], output_path: str, fps: int) -> None:
    import cv2

    width, height = images[0].size
    fourcc = cv2.VideoWriter.fourcc(*"mp4v")
    writer = cv2.VideoWriter(output_path, fourcc, fps, (width, height))
    if not writer.isOpened():
        raise RuntimeError(f"Could not open video writer for {output_path}")
    try:
        for img in images:
            frame = np.array(img.convert("RGB"))
            writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def write_images_as_temp_video(images: list[Image.Image], fps: int) -> str:
    with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as temp_file:
        output_path = temp_file.name
    write_images_as_video(images, output_path, fps)
    return output_path
