"""Serving runtime (``vision_ft_tpu/serving`` counterpart).

``continuous`` is step-level continuous batching for diffusion sampling:
a fixed pool of latent slots that requests join and leave at denoise-step
boundaries, behind the HTTP server's ``--scheduler continuous``
(``tools/inference_server.py``).
"""

from .continuous import (
    AuraFlowSlotAdapter,
    CogView4SlotAdapter,
    ContinuousBatcher,
    FluxSlotAdapter,
    Lumina2SlotAdapter,
    SDXLSlotAdapter,
    SlotRequest,
)

__all__ = [
    "AuraFlowSlotAdapter",
    "CogView4SlotAdapter",
    "ContinuousBatcher",
    "FluxSlotAdapter",
    "Lumina2SlotAdapter",
    "SDXLSlotAdapter",
    "SlotRequest",
]
