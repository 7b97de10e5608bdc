"""One sparse feature's bag config and table init (port of
``repro.core.embedding_bag``, config and init)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import qr_embedding
from repro_torch.core.qr_embedding import EmbeddingConfig


@dataclasses.dataclass(frozen=True)
class BagConfig:
    """One sparse feature's table + pooling semantics."""

    emb: EmbeddingConfig
    pooling: int = 32                 # indices per bag (multi-hot degree)
    combiner: str = "sum"             # sum | mean


def init_tables(bags: Sequence[BagConfig], *, generator: torch.Generator,
                device: torch.device) -> list[dict]:
    return [qr_embedding.init(b.emb, generator=generator, device=device) for b in bags]
