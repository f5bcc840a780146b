"""Which mixers of the Factorizer bundles run K5 on slabs and which run K1 gathered, on 2, 3 and 4 slabs.

Each bundle's network at its batch and roi, cut as the spatial step cuts it
(``parallel.slabs.slab_cut``): a mixer on a level that ``slab_route`` gathers
runs K1 on the whole tensor; the others ask ``FactMixer.gathers``, the spatial
step's rule, of their first slab.  For each K5 mixer, the bytes one process
hands to K5's exchanges in a forward and its backward
(``ops.kernels.windowed_sharded.exchange_bytes``), and per step and process
the K5 mixers, exchanges and bytes.  Counts from shapes alone, f32; the
network is built on the meta device, so this runs on a CPU:

    python tools/k5_routes.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from factorizer_tpu_torch import zoo_scripts  # noqa: E402
from factorizer_tpu_torch.models.factorizer import FactMixer  # noqa: E402
from factorizer_tpu_torch.ops.kernels.windowed_sharded import exchange_bytes  # noqa: E402
from factorizer_tpu_torch.parallel.slabs import Slabs, slab_cut, slab_route  # noqa: E402

# bundle -> (network factory, batch, roi side), as train_tp.yaml runs them.
BUNDLES = {"factorizer_brats23": ("brats23_network", 2, 128), "factorizer_isles22": ("factorizer_isles22_network", 8, 64)}


class _Line:
    """One axis of ``n`` processes seen from the first: all that ``FactMixer.gathers`` reads of a mesh."""

    def __init__(self, n: int) -> None:
        self.n = n

    def axis_size(self, axis: str) -> int:
        return self.n

    def axis_index(self, axis: str) -> int:
        return 0


def mixers(model) -> list[tuple[str, int, FactMixer]]:
    """(name, level, mixer) of every windowed mixer, encoder first."""
    n_enc = len(model.encoder.blocks)
    found = []
    for name, module in model.named_modules():
        if isinstance(module, FactMixer) and module.windowed is not None:
            part, index = name.split(".")[:3:2]
            found.append((name, int(index) if part == "encoder" else n_enc - 2 - int(index), module))
    return found


def routes(bundle: str, n: int) -> tuple[list[str], int, int]:
    """Each mixer's route on ``n`` slabs, and per step and process the K5 mixers and the bytes they hand over."""
    factory, batch, roi = BUNDLES[bundle]
    model = getattr(zoo_scripts, factory)(device="meta")
    cut = slab_cut(model, roi, n)
    gathered_from = slab_route(model, cut).level
    lines, k5, sent = [], 0, 0
    for name, level, mixer in mixers(model):
        side = roi >> level
        rows = cut.sizes(side)
        channels = mixer.out_proj.linear.weight.shape[0]
        x = torch.empty((batch, rows[0], side, side, channels), device="meta")
        if gathered_from is not None and level >= gathered_from:
            lines.append(f"{name} ({side}^3 x {channels}, slabs {rows}): K1, its level gathered")
            continue
        mixer.slabs = Slabs(_Line(n), "model", cut)
        if mixer.gathers(x):
            lines.append(f"{name} ({side}^3 x {channels}, slabs {rows}): K1 gathered by the rule")
        else:
            sent_here = exchange_bytes(x.shape, x.element_size(), *mixer.windowed)
            k5, sent = k5 + 1, sent + sent_here
            lines.append(f"{name} ({side}^3 x {channels}, slabs {rows}): K5, {sent_here / 1e6:.2f} MB a process")
        mixer.slabs = None
    return lines, k5, sent


def main() -> None:
    for bundle in BUNDLES:
        for n in (2, 3, 4):
            lines, k5, sent = routes(bundle, n)
            print(f"{bundle} on {n} slabs: {k5} K5 mixers, {4 * k5} exchanges and {sent / 1e6:.1f} MB a step and process")
            for line in lines:
                print(f"  {line}")


if __name__ == "__main__":
    main()
