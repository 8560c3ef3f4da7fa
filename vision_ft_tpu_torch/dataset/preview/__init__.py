from .text_to_image import T2IPreviewArgs, TextToImagePreviewConfig

__all__ = ["T2IPreviewArgs", "TextToImagePreviewConfig"]
