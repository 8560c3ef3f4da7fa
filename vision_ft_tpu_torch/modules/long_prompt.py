"""Long-prompt chunking for 77-token CLIP towers; a copy of the JAX
package's numpy-only ``vision_ft_tpu/modules/long_prompt.py``.

Tokenize to ``max_length + 2``, strip the outer bos/eos, reshape into
``max_length / chunk_length`` chunks, and re-insert bos/eos per chunk so
each 77-token window is a valid CLIP input.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, Sequence

import numpy as np


class TokenizerProtocol(Protocol):
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int

    def __call__(self, prompts: Sequence[str], max_length: int) -> np.ndarray: ...


class TokenizedResult(NamedTuple):
    input_ids: np.ndarray  # (batch * num_chunks, chunk_length + 2)
    attention_mask: np.ndarray


def tokenize_long_prompt(
    tokenizer: TokenizerProtocol,
    prompts: Sequence[str],
    max_length: int = 75 * 3,
    chunk_length: int = 75,
) -> TokenizedResult:
    if max_length % chunk_length != 0:
        raise ValueError(
            f"max_length {max_length} should be divisible by chunk_length {chunk_length}"
        )

    ids = np.asarray(tokenizer(list(prompts), max_length=max_length + 2))
    ids = ids[:, 1:-1]  # strip outer bos/eos

    num_chunks = max_length // chunk_length
    chunks = ids.reshape(-1, num_chunks, chunk_length)
    chunks = np.pad(
        chunks, ((0, 0), (0, 0), (1, 0)), constant_values=tokenizer.bos_token_id
    )
    chunks = np.pad(
        chunks, ((0, 0), (0, 0), (0, 1)), constant_values=tokenizer.eos_token_id
    )
    chunks = chunks.reshape(-1, chunk_length + 2)

    attention_mask = (chunks != tokenizer.pad_token_id).astype(np.int32)
    return TokenizedResult(chunks.astype(np.int32), attention_mask)
