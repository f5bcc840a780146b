"""Plain PyTorch training of the reference networks: the DiceCE loss, the gradient and an AdamW update.

The bundles' loss is MONAI's ``DiceCELoss(sigmoid=True, squared_pred=True)``
(smoothing 1e-5 in numerator and denominator, Dice averaged over batch and
channels, binary cross-entropy averaged over every voxel, the two summed).
The optimiser is ``torch.optim.AdamW``'s update (decoupled weight decay, bias
corrections), written out here so that it takes nothing from the program; the
bundles' warm-up and cosine schedule are left out (a constant learning rate).
"""

from __future__ import annotations

import torch

SMOOTH = 1e-5


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    probs = torch.sigmoid(logits)
    axes = tuple(range(2, logits.ndim))
    inter = (labels * probs).sum(axes)
    denom = (labels * labels).sum(axes) + (probs * probs).sum(axes)
    dice = 1.0 - (2.0 * inter + SMOOTH) / (denom + SMOOTH)
    bce = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return dice.mean() + bce.mean()


class AdamW:
    """AdamW over a dict of leaves, as ``torch.optim.AdamW`` computes it."""

    def __init__(self, params: dict, lr: float, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> None:
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(forward, weights: dict, net: dict, batches: list, lr: float, weight_decay: float,
                trainable: set) -> dict:
    """Run ``len(batches)`` steps of ``forward(params, image, net)`` (a reference family's) from ``weights`` (not
    changed; copies are trained).

    ``trainable`` names the leaves the optimiser updates (the others, the NMF
    starting factors, are buffers).  Returns the loss of every step, the first
    step's gradient of every trainable leaf, and the leaves after the last step.
    """
    params = {k: v.detach().clone() for k, v in weights.items()}
    leaves = {k: params[k] for k in params if k in trainable}
    opt = AdamW(leaves, lr, weight_decay)
    losses, first_grads = [], None
    for batch in batches:
        for v in leaves.values():
            v.requires_grad_(True)
        loss = dice_ce_loss(forward(params, batch["image"], net), batch["label"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        for v in leaves.values():
            v.requires_grad_(False)
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = grads
        opt.step(leaves, grads)
        del loss, grads
    return {"losses": losses, "first_grads": first_grads, "params": leaves}
