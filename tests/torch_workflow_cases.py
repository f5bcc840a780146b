"""Shared inputs of the workflow tests: synthetic BraTS-like NIfTI cases, a datalist, the bundle's transforms.

Not a test module: ``tests/test_torch_data.py`` and ``tests/test_torch_loop.py`` import it.
"""

import json
from pathlib import Path

import numpy as np
import yaml

TRAIN_YAML = Path(__file__).resolve().parents[1] / "zoo" / "factorizer_brats23" / "configs" / "train.yaml"


def brats_case(rng: np.random.Generator, shape=(20, 22, 18)):
    """Four float32 modalities and a uint8 label {0, 1, 2, 3}: an ellipsoid head on a zero background
    (so that CropForegroundd has a box to find) holding nested tumour regions."""
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    head = (grid**2).sum(0) < 0.8
    centre = rng.uniform(-0.2, 0.2, size=3)[:, None, None, None]
    r = np.sqrt(((grid - centre) ** 2).sum(0))
    label = np.zeros(shape, np.uint8)
    label[(r < 0.55) & head] = 2  # edema
    label[r < 0.35] = 1  # necrotic core
    label[r < 0.2] = 3  # enhancing
    images = []
    for m in range(4):
        img = rng.normal(1.0 + 0.3 * m, 0.2, size=shape) + 0.5 * label
        images.append(np.where(head, img, 0.0).astype(np.float32))
    return images, label


def write_cases(root: Path, n: int, save_nifti, shape=(20, 22, 18), seed: int = 0, suffix: str = ".nii.gz",
                folds: int = 2) -> Path:
    """``n`` cases under ``root/data`` and a Decathlon datalist ``root/datalist.json`` (fold ``i % folds``)."""
    rng = np.random.default_rng(seed)
    data = root / "data"
    items = []
    for i in range(n):
        case = data / f"case{i}"
        case.mkdir(parents=True)
        images, label = brats_case(rng, shape)
        names = []
        for m, img in enumerate(images):
            save_nifti(case / f"m{m}{suffix}", img)
            names.append(f"case{i}/m{m}{suffix}")
        save_nifti(case / f"seg{suffix}", label)
        items.append({"id": f"case{i}", "image": names, "label": f"case{i}/seg{suffix}", "fold": i % folds})
    datalist = root / "datalist.json"
    datalist.write_text(json.dumps({"training": items}))
    return datalist


def yaml_transforms(T, roi_size=(16, 16, 16)):
    """``deterministic_transforms`` and ``random_transforms`` of the bundle's train.yaml, built from the
    transforms module ``T`` with ``@roi_size`` set to ``roi_size`` and ``@pix_size`` as the file has it."""
    cfg = yaml.safe_load(TRAIN_YAML.read_text())
    refs = {"@roi_size": list(roi_size), "@pix_size": cfg["pix_size"]}

    def build(entries):
        out = []
        for entry in entries:
            kwargs = {k: refs.get(v, v) if isinstance(v, str) else v for k, v in entry.items() if k != "_target_"}
            out.append(getattr(T, entry["_target_"])(**kwargs))
        return T.Compose(out)

    return build(cfg["deterministic_transforms"]), build(cfg["random_transforms"])
