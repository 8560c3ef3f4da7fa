from .rope import (
    RoPEFrequency,
    apply_rope_qk,
    get_rope_frequencies,
    image_position_indices,
)

__all__ = [
    "RoPEFrequency",
    "apply_rope_qk",
    "get_rope_frequencies",
    "image_position_indices",
]
