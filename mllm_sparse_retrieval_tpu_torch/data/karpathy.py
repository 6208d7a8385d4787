"""Retrieval examples (the JAX package's ``data/karpathy.py``, cut to the
``Example`` record the trainer and its collator read; the Karpathy CSV
corpus is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Example:
    """One retrieval example: a caption paired with its image."""

    text: str
    image_path: str
    text_id: str
    img_id: str
