"""The networks' tensors, made by the benchmark from the seed, on the device, in two large calls.

Both sides take them: the program loads them into its model
(``load_state_dict``, strict), the reference computes with them.  Each tensor
is a slice of one ``torch.rand`` (and, for the positional embedding, one
``torch.randn``) drawn on the device from a generator seeded by the run's seed
and the stream (the fold), and shaped by its kind (a reference family's ``param_spec``):

* ``weight``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``fan_in`` the product of
  its shape after the first axis (torch's default bound);
* ``bias``: the same bound as the weight of its layer;
* ``norm_weight`` / ``norm_bias``: 1 + U(-0.1, 0.1) / U(-0.1, 0.1);
* ``nonneg``: U(0, 1), the bundles' "uniform" NMF starting factors;
* ``normal``: N(0, 1), the positional embedding's published init.
"""

from __future__ import annotations

import math

import torch

SEED_MIX = 1_000_003


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for (seed, stream): any whole seed, large ones included."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * SEED_MIX + int(stream)) % (2 ** 63))
    return g


def make_weights(spec: dict, seed: int, stream: int, device, dtype=torch.float32) -> dict:
    """name -> tensor for every entry of ``spec`` (name -> (shape, kind)) on ``device``: drawn in float32, then
    given ``dtype``, so that a seed's tensors are one set whatever the type."""
    g = generator(seed, stream, device)
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    normal_sizes = [n for n, (_, kind) in zip(sizes, spec.values()) if kind == "normal"]
    normal = torch.randn(sum(normal_sizes), generator=g, device=device) if normal_sizes else None
    out, at, at_normal = {}, 0, 0
    for (name, (shape, kind)), n in zip(spec.items(), sizes):
        u = uniform[at:at + n].view(shape)
        at += n
        if kind == "normal":
            t = normal[at_normal:at_normal + n].view(shape)
            at_normal += n
        elif kind in ("weight", "bias"):
            ref = shape if kind == "weight" else spec[name[: -len("bias")] + "weight"][0]
            bound = 1.0 / math.sqrt(math.prod(ref[1:]))
            t = (2 * u - 1) * bound
        elif kind == "norm_weight":
            t = 1 + 0.1 * (2 * u - 1)
        elif kind == "norm_bias":
            t = 0.1 * (2 * u - 1)
        elif kind == "nonneg":
            t = u.clone()
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        out[name] = t.to(dtype).contiguous()
    return out
