"""The four assigned input shapes (see the assignment brief)."""
from __future__ import annotations

from repro_torch.configs.base import InputShape

INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", seq_len=4_096, global_batch=256, mode="train"),
    "prefill_32k": InputShape("prefill_32k", seq_len=32_768, global_batch=32, mode="prefill"),
    "decode_32k": InputShape("decode_32k", seq_len=32_768, global_batch=128, mode="decode"),
    "long_500k": InputShape("long_500k", seq_len=524_288, global_batch=1, mode="decode"),
}


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]
