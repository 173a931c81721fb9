"""The precision of the reference's products and stored activations.

Every matrix product of the reference (convolutions, dense layers,
attention einsums) passes its operands through :func:`q`, and so does every
activation a layer hands on (a product's output, a norm's, a residual
sum). In the reference proper `q` is the identity and everything runs in
fp32 with TF32 off. The control of a bf16 configuration runs the same code
under :func:`emulate` with :func:`fp8_e4m3`: each of those tensors rounded
to fp8 (e4m3, one scale per tensor, its absolute maximum at 448), the
precision below the one the configuration states, as a program that
computes in fp8 would hold them.
"""

from __future__ import annotations

import contextlib

import torch

_ROUND = [None]
FP8_MAX = 448.0


def q(x: torch.Tensor) -> torch.Tensor:
    """The operand of a product, rounded as the active mode says."""
    fn = _ROUND[0]
    return x if fn is None else fn(x)


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to fp8 e4m3 with a per-tensor scale, back in its dtype.
    The rounding passes the gradient through unchanged."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    y = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (y.to(x.dtype) - x).detach()


@contextlib.contextmanager
def emulate(fn):
    """Round every product operand of the reference with `fn` inside."""
    before = _ROUND[0]
    _ROUND[0] = fn
    try:
        yield
    finally:
        _ROUND[0] = before


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for matmuls and cuDNN convolutions inside (the
    control of an fp32 configuration whose products run with TF32 off)."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
