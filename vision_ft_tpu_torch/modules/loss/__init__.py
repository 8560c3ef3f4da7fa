from . import diffusion, flow_match, shortcut

__all__ = ["diffusion", "flow_match", "shortcut"]
