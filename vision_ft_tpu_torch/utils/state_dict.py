"""State-dict key targeting (``vision_ft_tpu/utils/state_dict.py``
counterpart): include/exclude selection of keys by substring or regex. The
OpenCLIP <-> transformers conversions of the JAX module belong to the
checkpoint I/O and are not ported yet."""

from __future__ import annotations

import re
from typing import Sequence

from pydantic import BaseModel


class RegexMatch(BaseModel):
    regex: str

    def __call__(self, value: str) -> bool:
        return bool(re.match(self.regex, value))


def get_target_keys(
    include: Sequence[str | RegexMatch],
    exclude: Sequence[str | RegexMatch],
    keys: list[str],
) -> list[str]:
    """Select keys matching any include pattern minus any exclude pattern.
    Strings match by substring; RegexMatch by ``re.match``."""
    matched: set[str] = set()
    for pattern in include:
        if isinstance(pattern, RegexMatch):
            compiled = re.compile(pattern.regex)
            matched.update(k for k in keys if compiled.match(k))
        else:
            matched.update(k for k in keys if pattern in k)
    for pattern in exclude:
        if isinstance(pattern, RegexMatch):
            compiled = re.compile(pattern.regex)
            matched.difference_update(k for k in keys if compiled.match(k))
        else:
            matched.difference_update(k for k in keys if pattern in k)
    return list(matched)
