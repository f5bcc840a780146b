"""K2: fused pre-norm MLP residual, forward (``csrc/mlp_block.cu``).

Counterpart of ``fused_prenorm_mlp`` in ``factorizer_tpu/ops/pallas/mlp_block.py``:
``y = x + fc2(gelu(fc1(layer_norm(x))))`` per token, with the hidden
activations kept out of device memory.  Parameters come in the torch
``nn.Linear`` layouts: ``w1 (H, C)``, ``w2 (C, H)``.

:func:`prenorm_mlp` launches the CUDA kernel for a CUDA tensor and runs
:func:`prenorm_mlp_plain` for a CPU tensor.  Both compute in float32 with
float32 parameters and cast the result to ``x``'s dtype; GELU is the exact
erf form.  Only the forward is a kernel so far: on the card the wrapper
refuses inputs that require a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build

__all__ = ["prenorm_mlp", "prenorm_mlp_plain", "KERNEL_WIDTHS"]

# Channel widths the kernel is instantiated for (one tile shape each).
KERNEL_WIDTHS = (32, 64, 128, 256, 512)


def prenorm_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version, in float32, cast back to ``x``'s dtype."""
    xf = x.float()
    h = F.linear(F.layer_norm(xf, (xf.shape[-1],), gamma, beta, eps), w1, b1)
    return (xf + F.linear(F.gelu(h), w2, b2)).to(x.dtype)


def prenorm_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` over the trailing axis of ``x (..., C)``; K2 on the card."""
    if not build.launches_kernel(x):
        return prenorm_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps)

    c = x.shape[-1]
    hidden = w1.shape[0]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"the kernel covers C in {KERNEL_WIDTHS}, got C={c}")
    expected = {"gamma": (c,), "beta": (c,), "w1": (hidden, c), "b1": (hidden,), "w2": (c, hidden), "b2": (c,)}
    params = {"gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2, "b2": b2}
    for name, p in params.items():
        if tuple(p.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, expected {expected[name]}")
        if p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in params.values())):
        raise NotImplementedError("the fused MLP backward kernel is not ported yet")
    dtype = build.dtype_code(x.dtype)
    lib = build.library()
    y = torch.empty_like(x)
    status = lib.ftt_prenorm_mlp(
        x.data_ptr(), y.data_ptr(), *(p.data_ptr() for p in params.values()),
        dtype, x.numel() // c, c, hidden, eps, build.stream_of(x),
    )
    build.check(status, "prenorm_mlp")
    prenorm_mlp.launches += 1
    return y


prenorm_mlp.launches = 0
