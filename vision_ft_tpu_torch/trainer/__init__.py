from .common import Trainer

__all__ = ["Trainer"]
