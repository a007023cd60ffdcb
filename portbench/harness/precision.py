"""The references' arithmetic: float32 products without TF32."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["fp32_exact"]


@contextmanager
def fp32_exact() -> Iterator[None]:
    """TF32 off for matrix products and convolutions inside the block;
    the process's settings restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
