"""A model run on slabs of its input: the first spatial axis cut over one axis of the process mesh.

The port's counterpart of what GSPMD does for the JAX package's spatial
train step (``factorizer_tpu/train/trainer.py:106,200`` constrains the
input's first spatial axis over ``model``; ``ops/pallas/partitioning.py``
gathers each Pallas kernel's operands).  Here nothing is inferred: the layers
that have a slab path read this process's :class:`Slabs` from their
``slabs`` attribute, which :func:`on_slabs` sets on them for the time of a
forward and its backward, and otherwise run as they always do:

* ``layers.basic``: ``Conv`` with a kernel wider than 1 along the cut axis
  exchanges a halo of its padding rows (:func:`~.collectives.halo_exchange`)
  and pads none there; a stride-s one needs a row count per slab that s
  divides (else it raises, naming the layer); ``ConvTranspose`` with a kernel
  equal to its stride and the pointwise convolutions are local;
  ``InstanceNorm``, ``GroupNorm`` and ``FlaxGroupNorm`` take the whole
  volume's statistics (:func:`~.collectives.slab_sum`, whose backward sums
  the cotangent over the slabs);
* ``UNet``: the stem, the resampling layers, the heads (the deep-supervision
  heads too, k1 convolutions, with ``deep_supervision_loss(slabs=)``) and the
  generic stage blocks through those layers; a part built of any other layer
  (``models.unet.SLAB_LAYERS``) is named by ``slab_path_missing``;
* ``Dropout``: each process draws its own mask for its slab;
* ``Deconv`` (the Deconver): each of the source update's three convolutions
  runs K3 on its slab and a halo of ``k1 // 2`` rows, cropped back;
* ``DynUNet``, its deep-supervision heads too, through the layers above;
* ``SegResNet``: the layers above, and the linear upsampling on a one-row
  halo that repeats the volume's edge rows (``edge="replicate"``);
* ``SwinUNETR`` and ``UNETR``: the convolutional parts on the slab, the
  transformer on the gathered tensor (:func:`~.collectives.gather_slabs` and
  :func:`~.collectives.cut_slab` with ``count_once``, so that the transformer's
  gradient, which every process computes whole, counts once in the step's sum);
* ``FactorizerStage``: this slab's rows of the positional embedding;
* ``FactMixer``: K5 (``ops.kernels.windowed_nmf_multi_spatial``) on the
  slab, or the stage's tensor gathered, K1 on the whole of it and this slab
  cut back out where the slab holds no whole number of patches or gathering
  sends fewer bytes (``FactMixer.gathers``);
* the block tails (K2), LayerNorm and the projections are per voxel.

A model tells what it lacks through ``slab_path_missing()`` (a reason, or
None when it has a slab path); a model without the method has none.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator

from torch import nn

from .mesh import Mesh

__all__ = ["Slabs", "on_slabs", "require_slab_path"]


@dataclass(frozen=True)
class Slabs:
    """This process's slab: the ``index``-th of ``n`` equal parts of the first spatial axis, over ``axis`` of ``mesh``."""

    mesh: Mesh
    axis: str = "model"

    @property
    def n(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)


def require_slab_path(model: nn.Module) -> None:
    """Raise ``NotImplementedError`` naming what ``model`` lacks to run on slabs; return if it has a slab path."""
    missing = getattr(model, "slab_path_missing", None)
    reason = f"{type(model).__name__} has no slab path" if missing is None else missing()
    if reason is not None:
        raise NotImplementedError(f"the spatial step (spatial_axis, shard_spatial) is not ported for this model: {reason}")


@contextlib.contextmanager
def on_slabs(model: nn.Module, slabs: Slabs) -> Iterator[nn.Module]:
    """Within the block, ``model`` takes and returns this process's slab ``(B, C, S1 / n, S2, S3)`` of its input.

    Run the backward inside the block too: a rematerialised stage runs its
    forward again there.  Raises first if the model has no slab path.
    """
    require_slab_path(model)
    holders = [m for m in model.modules() if hasattr(m, "slabs")]
    for m in holders:
        m.slabs = slabs
    try:
        yield model
    finally:
        for m in holders:
            m.slabs = None
