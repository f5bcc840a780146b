"""The comparison that decides ``correct``: what the timed path produced against the plain reference.

Training (the first ``checked_steps`` steps, which set-up drives through the
window's own step on rows that all differ):

* ``loss_gap``: the largest of the steps' ``|loss - loss_ref| / |loss_ref|``;
  ``loss_gap_first``: the first step's;
* ``grad_gap``: the worst leaf of the first step's gradient as the optimiser
  got it (AdamW's first moment after one step over ``1 - beta1``):
  ``|norm - norm_ref| / max(norm_ref, median leaf's norm_ref)``;
* ``change_gap``: the same of each leaf's change over the checked steps, where
  leaves whose reference gradient is under a thousandth of the median leaf's
  (nought to rounding, which AdamW's sign-like steps would magnify) are left out;
  ``change_gap_median``: the median leaf's of those gaps.

Serving (the sampled cases' answers, kept on the host from the window):

* ``probs_gap``: the largest ``|p - p_ref|`` of the fold ensemble's mean
  probabilities over every voxel and class;
* ``mask_gap``: voxels whose mask differs from ``p_ref > 0.5`` where
  ``|p_ref - 0.5|`` exceeds the limit of ``probs_gap`` (exact: limit 0).

A cell's limits file names the numbers it compares; each is printed beside its
limit, and a run is correct where each is finite and at most its limit and no
unit failed.  The others are read and printed, not compared.
"""

from __future__ import annotations

import math

import torch

GRAD_FLOOR = 1e-3  # share of the median leaf's gradient norm below which a leaf's change is not compared


def _median(values: list) -> float:
    v = sorted(values)
    n = len(v)
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def leaf_gaps(prog: dict, ref: dict, keys) -> list:
    """``|prog[k] - ref[k]| / max(ref[k], median of ref)`` for each of ``keys`` (norms, floats)."""
    keys = list(keys)
    med = _median([ref[k] for k in keys])
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def worst_leaf(prog: dict, ref: dict, keys) -> float:
    return max(leaf_gaps(prog, ref, keys))


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: ``losses`` (floats), ``grad_norms`` and ``change_norms`` (name -> float)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    keys = sorted(ref["grad_norms"])
    med_grad = _median([ref["grad_norms"][k] for k in keys])
    moved = [k for k in keys if ref["grad_norms"][k] >= GRAD_FLOOR * med_grad]
    change_gaps = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap, "loss_gap_first": abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
            "grad_gap": worst_leaf(prog["grad_norms"], ref["grad_norms"], keys),
            "change_gap": max(change_gaps), "change_gap_median": _median(change_gaps)}


def serve_numbers(answers: list, refs: list, probs_limit: float) -> dict:
    """``answers``: (mask, probs) of each checked case; ``refs``: the reference's probabilities of each."""
    probs_gap, mask_gap = 0.0, 0
    for (mask, probs), p_ref in zip(answers, refs):
        p_ref = p_ref.to(probs.device)
        probs_gap = max(probs_gap, float((probs - p_ref).abs().max()))
        decided = (p_ref - 0.5).abs() > probs_limit
        mask_gap += int(((mask.to(probs.device, torch.bool) != (p_ref > 0.5)) & decided).sum())
    return {"probs_gap": probs_gap, "mask_gap": mask_gap}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that the cell's limits name finite and within its limit, name -> {"value", "limit"}).  A
    number the limits leave out is read, not compared."""
    shown = {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}
    ok = all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in shown.values())
    return ok, shown


def leaf_norms(tensors: dict, scale: float = 1.0) -> dict:
    """name -> float norm of each tensor times ``scale``, read in one transfer."""
    names = sorted(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[k].detach().to(torch.promote_types(tensors[k].dtype, torch.float32)).norm()
                         for k in names]).cpu().tolist()
    return {k: v * scale for k, v in zip(names, norms)}
