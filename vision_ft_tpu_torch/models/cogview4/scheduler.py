"""CogView4 time shift (``vision_ft_tpu/models/cogview4/scheduler.py``
counterpart)."""

from __future__ import annotations


def calculate_time_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    base_shift: float = 0.25,
    max_shift: float = 0.75,
) -> float:
    m = (image_seq_len / base_seq_len) ** 0.5
    return m * max_shift + base_shift
