"""K2: fused pre-norm MLP residual, forward and backward (``csrc/mlp_block.cu``, ``csrc/mlp_block_bwd.cu``).

Counterpart of ``fused_prenorm_mlp`` in ``factorizer_tpu/ops/pallas/mlp_block.py``:
``y = x + fc2(gelu(fc1(layer_norm(x))))`` per token, with the hidden
activations kept out of device memory in both directions.  Parameters come in
the torch ``nn.Linear`` layouts: ``w1 (H, C)``, ``w2 (C, H)``.

:func:`prenorm_mlp` launches the forward kernel for a CUDA tensor and is
differentiable in ``x`` and the six parameters: its backward
(:func:`prenorm_mlp_backward`) recomputes the hidden activations per token
tile from the saved ``x`` and sums the parameter gradients in a fixed order
(per-group partial sums, then one pass over the groups), so a gradient is the
same from run to run.  A CPU tensor takes :func:`prenorm_mlp_plain`, which
autograd differentiates; :func:`prenorm_mlp_backward_plain` is that gradient
by name.  Everything computes in float32 with float32 parameters and casts to
``x``'s dtype; GELU and its derivative are the exact erf forms.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

__all__ = ["prenorm_mlp", "prenorm_mlp_plain", "prenorm_mlp_backward", "prenorm_mlp_backward_plain", "forward_shares",
           "KERNEL_WIDTHS"]

# Channel widths the kernel is instantiated for (one tile shape each).
KERNEL_WIDTHS = (32, 64, 128, 256, 512)
PARAM_NAMES = ("gamma", "beta", "w1", "b1", "w2", "b2")


def prenorm_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version, in float32, cast back to ``x``'s dtype (float64 stays float64, for semantic checks)."""
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt)
    gamma, beta, w1, b1, w2, b2 = (p.to(dt) for p in (gamma, beta, w1, b1, w2, b2))
    h = F.linear(F.layer_norm(xf, (xf.shape[-1],), gamma, beta, eps), w1, b1)
    return (xf + F.linear(F.gelu(h), w2, b2)).to(x.dtype)


def prenorm_mlp_backward_plain(x, g, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> tuple[torch.Tensor, ...]:
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)`` for the cotangent ``g``: autograd through :func:`prenorm_mlp_plain`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, gamma, beta, w1, b1, w2, b2)]
        y = prenorm_mlp_plain(*leaves, eps)
        return torch.autograd.grad(y, leaves, g)


def _check(x, params: dict) -> tuple[int, int]:
    """Raise on what the kernels do not take; returns ``(C, H)``."""
    c = x.shape[-1]
    hidden = params["w1"].shape[0]
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"the kernel covers C in {KERNEL_WIDTHS}, got C={c}")
    expected = {"gamma": (c,), "beta": (c,), "w1": (hidden, c), "b1": (hidden,), "w2": (c, hidden), "b2": (c,)}
    for name, p in params.items():
        if tuple(p.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(p.shape)}, expected {expected[name]}")
        if p.dtype != torch.float32 or p.device != x.device or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return c, hidden


def forward_shares(tokens: int, c: int, hidden: int) -> int:
    """Shares of the hidden width that the forward kernel splits ``tokens`` tokens into on the current card: the
    kernel's own plan (``plan_shares`` in ``csrc/mlp_block.cu``).  Above 1, the shares' partial sums take
    ``(shares, tokens, C)`` f32 of scratch."""
    shares = ctypes.c_int(0)
    build.check(build.library().ftt_prenorm_mlp_shares(tokens, c, hidden, ctypes.byref(shares)), "prenorm_mlp_shares")
    return shares.value


def _backward_scratch(tokens: int, c: int, hidden: int, dtype: torch.dtype) -> int:
    """Floats of f32 scratch the backward kernel needs for ``tokens`` tokens on the current card, by its own plan
    (``make_plan`` in ``csrc/mlp_block_bwd.cu``): the partial parameter gradients of its groups of token tiles and,
    where it splits the hidden width into shares, the shares' partial ``dxn``."""
    floats = ctypes.c_longlong(0)
    status = build.library().ftt_prenorm_mlp_bwd_scratch(tokens, c, hidden, build.dtype_code(dtype), ctypes.byref(floats))
    build.check(status, "prenorm_mlp_bwd_scratch")
    return floats.value


def _launch_forward(x, params: dict, eps: float) -> torch.Tensor:
    c, hidden = _check(x, params)
    for name, t in (("x", x), *params.items()):
        build.check_aligned(name, t)
    dtype = build.dtype_code(x.dtype)
    lib = build.library()
    tokens = x.numel() // c
    shares = forward_shares(tokens, c, hidden)
    partial = torch.empty(shares, tokens, c, dtype=torch.float32, device=x.device) if shares > 1 else None
    # bf16 and f16 activations: the kernel's operands are the weights' copy in that type, made in this scratch.
    wconv = torch.empty(2 * hidden * c, dtype=x.dtype, device=x.device) if x.dtype in (torch.bfloat16, torch.float16) else None
    y = torch.empty_like(x)
    status = lib.ftt_prenorm_mlp(
        x.data_ptr(), y.data_ptr(), *(p.data_ptr() for p in params.values()),
        None if partial is None else partial.data_ptr(), None if wconv is None else wconv.data_ptr(), dtype, tokens,
        c, hidden, eps, build.stream_of(x),
    )
    build.check(status, "prenorm_mlp")
    prenorm_mlp.launches += 1
    return y


def prenorm_mlp_backward(x, g, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> tuple[torch.Tensor, ...]:
    """``(dx, dgamma, dbeta, dw1, db1, dw2, db2)`` of :func:`prenorm_mlp` for the cotangent ``g``.

    The backward kernel on the card, plain on the CPU.  ``g`` has ``x``'s shape
    and dtype; ``dx`` too, and the parameter gradients are float32.
    """
    if not build.launches_kernel(x):
        return prenorm_mlp_backward_plain(x, g, gamma, beta, w1, b1, w2, b2, eps)
    params = dict(zip(PARAM_NAMES, (gamma, beta, w1, b1, w2, b2)))
    c, hidden = _check(x, params)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device or not g.is_contiguous():
        raise ValueError("g must be a contiguous tensor of x's shape, dtype and device")
    for name, t in (("x", x), ("g", g), ("w1", params["w1"]), ("w2", params["w2"])):
        build.check_aligned(name, t)
    tokens = x.numel() // c
    scratch = torch.empty(_backward_scratch(tokens, c, hidden, x.dtype), dtype=torch.float32, device=x.device)
    sizes = [p.numel() for p in params.values()]
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    status = build.library().ftt_prenorm_mlp_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), *(p.data_ptr() for p in params.values()),
        scratch.data_ptr(), scratch.numel(), grads.data_ptr(), build.dtype_code(x.dtype), tokens, c, hidden, eps,
        build.stream_of(x),
    )
    build.check(status, "prenorm_mlp_bwd")
    prenorm_mlp_backward.launches += 1
    return (dx, *(t.view(p.shape) for t, p in zip(grads.split(sizes), params.values())))


prenorm_mlp_backward.launches = 0


class _PrenormMLP(torch.autograd.Function):
    """The kernels under autograd: forward saves ``x`` and the parameters, the hidden activations are recomputed."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.eps = eps
        return _launch_forward(x, dict(zip(PARAM_NAMES, (gamma, beta, w1, b1, w2, b2))), eps)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors  # read once: a checkpointed graph unpacks each saved tensor once
        grads = prenorm_mlp_backward(x, g.contiguous(), *params, ctx.eps)
        return (*(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad)), None)


def prenorm_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-5) -> torch.Tensor:
    """``x + fc2(gelu(fc1(LN(x))))`` over the trailing axis of ``x (..., C)``; K2 on the card, plain on the CPU."""
    if not build.launches_kernel(x):
        return prenorm_mlp_plain(x, gamma, beta, w1, b1, w2, b2, eps)
    leaves = (x, gamma, beta, w1, b1, w2, b2)
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in leaves)):  # no graph to record
        return _launch_forward(x, dict(zip(PARAM_NAMES, leaves[1:])), eps)
    return _PrenormMLP.apply(x, gamma, beta, w1, b1, w2, b2, eps)


prenorm_mlp.launches = 0
