from . import diffusion, flow_match

__all__ = ["diffusion", "flow_match"]
