from .clip import CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection
from .gemma2 import Gemma2Config, Gemma2Model
from .glm import GlmConfig, GlmModel
from .tokenizer import CLIPTokenizer

__all__ = [
    "CLIPTextConfig",
    "CLIPTextModel",
    "CLIPTextModelWithProjection",
    "CLIPTokenizer",
    "Gemma2Config",
    "Gemma2Model",
    "GlmConfig",
    "GlmModel",
]
