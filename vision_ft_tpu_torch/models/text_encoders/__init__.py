from .clip import CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection
from .tokenizer import CLIPTokenizer

__all__ = ["CLIPTextConfig", "CLIPTextModel", "CLIPTextModelWithProjection", "CLIPTokenizer"]
