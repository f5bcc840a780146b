"""Export a JAX (orbax) checkpoint of the JAX package's models as a flat ``.npz`` that the PyTorch port reads.

Run from the repository root on a machine with the JAX package (the CPU will do):

    python3 tools/export_jax_checkpoint.py CKPT OUT.npz

``CKPT`` is any layout that ``factorizer_tpu.zoo_scripts`` restores: a one-shot
``save_checkpoint`` directory, a ``CheckpointManager`` step directory, or the
trainer's ``ckpt_dir`` (its newest step).  The model's ``params`` and
``buffers`` collections are written as one array per leaf, keyed by the Flax
path joined with ``/`` (``params/unet/stem/conv/kernel``,
``buffers/unet/enc0/block0/fact/factorize_op/initializer/u0``); the optimiser
state and the step are left out.  ``factorizer_tpu_torch.zoo_scripts.load_model_checkpoint``
reads the file (through ``utils/weights.py::flax_state_dict``), so the bundles'
``evaluate.yaml`` and ``inference.yaml`` take it as ``ckpt_path`` or among
``ckpt_paths`` on the port.  Prints the path and the number of leaves.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from factorizer_tpu.train.checkpoint import restore_checkpoint  # noqa: E402
from factorizer_tpu.zoo_scripts import _resolve_checkpoint_dir  # noqa: E402

COLLECTIONS = ("params", "buffers")


def flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts of arrays -> ``{"a/b/c": array}``."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def export(ckpt_path, out_path) -> dict[str, np.ndarray]:
    """Restore ``ckpt_path`` and write its ``params`` and ``buffers`` to ``out_path``; returns what was written."""
    restored = restore_checkpoint(_resolve_checkpoint_dir(ckpt_path))
    flat = flatten({name: restored[name] for name in COLLECTIONS if restored.get(name)})
    if not any(k.startswith("params/") for k in flat):
        raise ValueError(f"{ckpt_path}: the checkpoint holds no params")
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "wb") as f:  # a file object, so numpy does not append ".npz" to the name
        np.savez(f, **flat)
    return flat


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt", help="a JAX checkpoint: one-shot, step directory or the trainer's ckpt_dir")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    flat = export(args.ckpt, args.out)
    print(f"{args.out}: {len(flat)} leaves")


if __name__ == "__main__":
    main()
