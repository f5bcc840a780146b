"""Where an epoch of the PyTorch port's training workflow goes: the loader against the steps on the card.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/profile_torch_workflow.py [--epochs 4] [--workers 8]

Writes 5 synthetic BraTS-native cases as ``.nii.gz`` (``chip_smoke.py``'s
``brats_native_case``: 4 x (240, 240, 155) float32 and a label) to a
temporary directory, times one case through the bundle's deterministic
transforms and through its random tail in the main thread, then trains
``brats23_network()`` (full width, float32, seed 0, the bundle's lr, weight
decay and warm-up) with ``SegmentationTrainer`` for ``--epochs`` epochs over
the 4 training cases (batch 2) three times, each from a new network: with a
``DataLoader`` of ``--workers`` threads (the default), of ``--workers`` forked
processes (``use_processes=True, persistent_workers=True``), and over batches
made before the run (no loader work during the epochs).  Before that, each
transform on its own on one case (a random one forced to fire).  Per epoch it prints
the wall seconds, the seconds the loop waited on the loader, and the steps'
seconds on the card (CUDA events around each step, from ``trainer.timings``).
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Prefetched:
    """The batches of one pass over ``loader``, made before the run: iterating costs no loader work."""

    def __init__(self, loader) -> None:
        self.batches = list(loader)

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=4)
    parser.add_argument("--workers", type=int, default=8)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_torch_workflow: no CUDA device")
    import chip_smoke
    from factorizer_tpu_torch.data import DataLoader, Dataset, load_decathlon_datalist, save_nifti
    from factorizer_tpu_torch.data.transforms import Compose
    from factorizer_tpu_torch.train.loop import SegmentationTrainer
    from factorizer_tpu_torch.zoo_scripts import brats23_network, brats23_transforms

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    affine = np.asarray(chip_smoke.WORKFLOW_AFFINE)
    with tempfile.TemporaryDirectory(prefix="workflow_") as tmp:
        root = Path(tmp)
        items = []
        for i in range(5):
            images, label = chip_smoke.brats_native_case(np.random.default_rng(123 + i))
            (root / f"case{i}").mkdir()
            names = [f"case{i}/m{m}.nii.gz" for m in range(4)]
            for name, image in zip(names, images):
                save_nifti(root / name, image, affine)
            save_nifti(root / f"case{i}/seg.nii.gz", label, affine)
            items.append({"id": f"case{i}", "image": names, "label": f"case{i}/seg.nii.gz", "fold": 0 if i == 0 else 1})
        (root / "datalist.json").write_text(json.dumps({"training": items}))
        train_items = load_decathlon_datalist(root / "datalist.json", "training", fold=0, base_dir=root)
        deterministic, augment = brats23_transforms()
        augment.set_random_state(1)
        t0 = time.perf_counter()
        case = deterministic(dict(train_items[0]))
        t1 = time.perf_counter()
        augment(case)
        print(f"[workflow profile] one case in the main thread: deterministic transforms {t1 - t0:.3f} s "
              f"(volume {case['image'].shape}), random tail {time.perf_counter() - t1:.3f} s")
        # Each transform on its own, in the pipeline's order; a random one forced to fire (its cost when it does,
        # beside the bundle's probability).
        sample = dict(train_items[0])
        for t in deterministic.transforms + augment.transforms:
            prob = getattr(t, "prob", None)
            forced = copy.copy(t)
            if prob is not None:
                forced.prob = 1.0
            t0 = time.perf_counter()
            sample = forced(sample)
            print(f"[workflow profile]   {type(t).__name__}: {time.perf_counter() - t0:.3f} s"
                  + (f" when it fires (probability {prob})" if prob is not None else ""))
        dataset = Dataset(train_items, Compose(deterministic.transforms + augment.transforms))
        loaders = {
            "threads": lambda: DataLoader(dataset, batch_size=2, shuffle=True, num_workers=args.workers, drop_last=True),
            "processes": lambda: DataLoader(dataset, batch_size=2, shuffle=True, num_workers=args.workers, drop_last=True,
                                            use_processes=True, persistent_workers=True),
            "prefetched": lambda: Prefetched(DataLoader(dataset, batch_size=2, shuffle=True, num_workers=args.workers,
                                                        drop_last=True)),
        }
        for name, make in loaders.items():
            loader = make()
            trainer = SegmentationTrainer(brats23_network(generator=torch.Generator().manual_seed(0)), loader,
                                          max_epochs=args.epochs, lr=1e-4, weight_decay=1e-5, warmup_epochs=5)
            trainer.run()
            for t, h in zip(trainer.timings, trainer.history):
                print(f"[workflow profile] {name} epoch {t['epoch'] + 1}: {h['time_s']:.3f} s, loader wait "
                      f"{t['loader_wait_s']:.3f} s, steps on the card {t['step_device_s']:.3f} s = "
                      f"{t['step_device_s'] / t['steps']:.4f} s/step")
            if hasattr(loader, "close"):
                loader.close()
            del trainer, loader
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
