"""Assigned input shapes (one set shared by all LM archs)."""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}
