"""The one generator of the benchmark's inputs: a traffic mix's parameters and the seed make every input.

The mixes of the two kinds of traffic that ``kinds/`` runs, named by the file's ``kind``:

* ``train``: a closed loop of train steps on a ring of ``ring`` seeded
  batches made on the device: a ``randn`` image ``(batch, C_in, *roi)`` and
  the labels of a thresholded smooth field (:func:`synthetic_batch`).  The
  first ``checked_steps`` steps are the ones the reference follows.
* ``serve``: a closed loop of cases, one at a time, in the fixed order
  ``pattern`` (indices into ``shapes``) repeated: a ``randn`` 4-channel f32
  image of the case's shape, made on the device and handed over on the host,
  where a clinic's preprocessed image is; blended in the sliding window by
  ``mode``.

The seed changes every voxel and label; the sizes and their order come from the
file alone, so every seed gives the same work.
"""

from __future__ import annotations

import random

import torch
import torch.nn.functional as F

from .weights import generator

TRAIN_STREAM, SERVE_STREAM = 1 << 20, 1 << 21


def synthetic_batch(b: int, c_in: int, c_out: int, roi, coarse: int, threshold: float, gen,
                    dtype=torch.float32) -> dict:
    """A ``randn`` image and the labels of a thresholded smooth random field, made on the generator's device.

    A copy of ``chip_smoke.py::synthetic_batch`` / ``roi_batch`` (commit ef50548) for a roi of any rank, with the
    generator passed in, the field's coarse size and threshold as parameters, and the batch in ``dtype`` (drawn in
    float32)."""
    device = gen.device
    image = torch.randn(b, c_in, *roi, device=device, generator=gen)
    coarse_field = torch.randn(b, c_out, *(min(coarse, s) for s in roi), device=device, generator=gen)
    mode = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(roi)]
    field = F.interpolate(coarse_field, size=tuple(roi), mode=mode, align_corners=False)
    return {"image": image.to(dtype), "label": (field > threshold).to(dtype)}


def train_ring(traffic: dict, net: dict, seed: int, device, dtype=torch.float32) -> list[dict]:
    g = generator(seed, TRAIN_STREAM, device)
    label = traffic["label"]
    return [synthetic_batch(traffic["batch"], net["in_channels"], net["out_channels"], traffic["roi"],
                            label["coarse"], label["threshold"], g, dtype) for _ in range(traffic["ring"])]


def serve_cycle(traffic: dict) -> list[tuple]:
    """The shapes of one cycle of cases, in order."""
    return [tuple(traffic["shapes"][i]["shape"]) for i in traffic["pattern"]]


def serve_cases(traffic: dict, net: dict, seed: int, device, dtype=torch.float32) -> list[torch.Tensor]:
    """One cycle of case images ``(1, C_in, *shape)`` in ``dtype`` on the host, made on ``device`` from the seed."""
    g = generator(seed, SERVE_STREAM, device)
    return [torch.randn(1, net["in_channels"], *shape, device=device, generator=g).to(dtype).cpu()
            for shape in serve_cycle(traffic)]


def serve_checked(traffic: dict, seed: int) -> list[int]:
    """The positions in the cycle whose answers are compared with the reference: one of the cases with the most
    windows, and ``check_cases - 1`` others, drawn from the seed."""
    rng = random.Random(int(seed) * 7919 + 17)
    windows = [traffic["shapes"][i]["windows"] for i in traffic["pattern"]]
    largest = [k for k, w in enumerate(windows) if w == max(windows)]
    first = rng.choice(largest)
    rest = rng.sample([k for k in range(len(windows)) if k != first], traffic["check_cases"] - 1)
    return sorted([first, *rest])
