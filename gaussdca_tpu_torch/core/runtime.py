"""Run-time settings shared by the one-device and the mesh pipelines."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmuls():
    """TF32 off for matmuls and convolutions, the caller's settings
    restored afterwards: TF32 keeps ~3 digits, and the scores amplify
    the loss through cond(C) (the analogue of JAX's "highest")."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def no_mark(stage: str) -> None:
    """The default stage hook of the pipelines: does nothing."""
