"""The port's data pipeline: its modules pinned to the JAX package's, NIfTI IO, the bundle's transforms and the loaders.

The port keeps its own copy of ``factorizer_tpu/data`` (numpy, scipy, ctypes
and g++; no jax).  The copy differs only in docstrings and comments, which the
first two tests hold it to, so the same seed gives the same arrays in both
packages; the rest run the copy and compare with the JAX package's results
exactly (all arrays bit for bit).
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from factorizer_tpu import data as jax_data
from factorizer_tpu.data import transforms as jax_T

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch import data as port_data
from factorizer_tpu_torch.data import native as port_native
from factorizer_tpu_torch.data import transforms as port_T
from torch_workflow_cases import brats_case, write_cases, yaml_transforms

torch.set_num_threads(1)

JAX_DIR = Path(jax_data.__file__).parent
PORT_DIR = Path(port_data.__file__).parent


def _without_docstrings(tree: ast.AST) -> str:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
                    and isinstance(body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["__init__.py", "nifti.py", "native.py", "dataset.py", "transforms.py"])
def test_copied_module_matches_the_original(name):
    """Each data module's syntax tree, docstrings removed, equals the JAX package's (comments are not in it)."""
    port = _without_docstrings(ast.parse((PORT_DIR / name).read_text()))
    original = _without_docstrings(ast.parse((JAX_DIR / name).read_text()))
    assert port == original


@pytest.mark.parametrize("name", ["nifti_decode.cpp", "affine_resample.cpp"])
def test_native_sources_match_the_original(name):
    """The two C++ sources match the JAX package's byte for byte, comment lines aside."""

    def code_lines(path):
        return [ln for ln in path.read_text().splitlines() if not ln.lstrip().startswith("//")]

    assert code_lines(PORT_DIR / "_native" / name) == code_lines(JAX_DIR / "_native" / name)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_roundtrip_and_cross_read(tmp_path, suffix):
    """The port writes a volume with its affine and reads it back exactly; the JAX reader reads the same bytes."""
    data = np.random.default_rng(0).random((7, 9, 11)).astype(np.float32)
    affine = np.array([[0, -1.5, 0, 10], [2.0, 0, 0, -5], [0, 0, 1.0, 3], [0, 0, 0, 1]], float)
    path = tmp_path / f"vol{suffix}"
    ftt.save_nifti(path, data, affine)
    img = ftt.load_nifti(path)
    np.testing.assert_array_equal(img.data, data)
    np.testing.assert_allclose(img.affine, affine, atol=1e-6)  # the header stores float32
    other = jax_data.load_nifti(path)
    np.testing.assert_array_equal(other.data, img.data)
    np.testing.assert_array_equal(other.affine, img.affine)
    labels = (data * 4).astype(np.uint8)
    ftt.save_nifti(tmp_path / f"lbl{suffix}", labels)
    np.testing.assert_array_equal(ftt.load_nifti(tmp_path / f"lbl{suffix}").data, labels)


def test_native_decoder_matches_numpy_reader(tmp_path, monkeypatch):
    """Where g++ and zlib build the native decoder, it decodes as the numpy reader does, bit for bit."""
    if not port_native.native_available():
        pytest.skip("no g++/zlib here: the loader uses the numpy reader")
    vol = np.random.default_rng(1).standard_normal((12, 10, 6)).astype(np.float32)
    ftt.save_nifti(tmp_path / "v.nii.gz", vol, np.diag([1.2, 0.9, 2.0, 1.0]))
    native = ftt.load_nifti(tmp_path / "v.nii.gz", dtype=np.float32)
    assert native.header == {"native": True}
    monkeypatch.setenv("FTX_NATIVE", "0")
    plain = ftt.load_nifti(tmp_path / "v.nii.gz", dtype=np.float32)
    np.testing.assert_array_equal(native.data, plain.data)
    np.testing.assert_array_equal(native.affine, plain.affine)


def _pair(tmp_path):
    """One BraTS-like case as the datalist loader gives it to the transforms."""
    datalist = write_cases(tmp_path, 1, ftt.save_nifti, seed=3)
    return ftt.load_decathlon_datalist(datalist, base_dir=tmp_path / "data")[0]


def test_bundle_transforms_helper_matches_train_yaml(tmp_path):
    """``brats23_transforms`` builds train.yaml's two lists (same classes, same arguments) and gives the same arrays."""
    item = _pair(tmp_path)
    det, aug = ftt.brats23_transforms(roi_size=(16, 16, 16))
    det_y, aug_y = yaml_transforms(port_T, (16, 16, 16))
    assert [type(t) for t in det.transforms + aug.transforms] == [type(t) for t in det_y.transforms + aug_y.transforms]
    for a, b in zip(det.transforms + aug.transforms, det_y.transforms + aug_y.transforms):
        public = [{k: v for k, v in vars(t).items() if not k.startswith("_")} for t in (a, b)]
        assert public[0].keys() == public[1].keys(), type(a)
        for k, v in public[0].items():
            assert np.array_equal(np.asarray(v, dtype=object), np.asarray(public[1][k], dtype=object)), (type(a), k)
    aug.set_random_state(5)
    aug_y.set_random_state(5)
    out, ref = aug(det(dict(item))), aug_y(det_y(dict(item)))
    np.testing.assert_array_equal(out["image"], ref["image"])
    np.testing.assert_array_equal(out["label"], ref["label"])


@pytest.mark.parametrize("tail", ["deterministic", "random"])
def test_bundle_pipeline_matches_jax(tmp_path, tail):
    """The bundle's transforms (train.yaml, roi 16^3) give the JAX package's arrays bit for bit on one seed:
    image float32 (4, 16, 16, 16) normalised, label uint8 one-hot (3, 16, 16, 16), the same meta affine."""
    item = _pair(tmp_path)
    outs = []
    for T in (port_T, jax_T):
        det, aug = yaml_transforms(T)
        d = det(dict(item))
        if tail == "random":
            for seed in (11, 12, 13):  # a few draws, so the probability-0.2 transforms fire too
                aug.set_random_state(seed)
                d = aug(d)
        outs.append(d)
    out, ref = outs
    assert out["image"].dtype == np.float32 and out["label"].dtype == np.uint8
    assert out["label"].shape[0] == 3 and set(np.unique(out["label"])) <= {0, 1}
    np.testing.assert_array_equal(out["image"], ref["image"])
    np.testing.assert_array_equal(out["label"], ref["label"])
    np.testing.assert_array_equal(out["image_meta"]["affine"], ref["image_meta"]["affine"])


@pytest.mark.parametrize("workers,processes,random_tail", [(0, False, True), (2, False, False), (2, True, False)])
def test_loader_batches_match_jax(tmp_path, workers, processes, random_tail):
    """A shuffled loader over four cases yields the JAX package's batches, epoch for epoch, in the main process
    (with the random tail: one stream, one order) and in thread and process workers (deterministic tail:
    the workers' streams depend on which worker takes which case)."""
    datalist = write_cases(tmp_path, 4, ftt.save_nifti, seed=4)
    seen = []
    for pkg, T in ((port_data, port_T), (jax_data, jax_T)):
        det, aug = yaml_transforms(T)
        aug.set_random_state(9)
        items = pkg.load_decathlon_datalist(datalist, base_dir=tmp_path / "data")
        ds = pkg.CacheDataset(items, transform=det, random_transform=aug if random_tail else None, num_workers=0)
        loader = pkg.DataLoader(ds, batch_size=2, shuffle=True, num_workers=workers, use_processes=processes, seed=3)
        epochs = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            epochs.append([(b["id"], b["image"], b["label"]) for b in loader])
        loader.close()
        seen.append(epochs)
    port, ref = seen
    for e_port, e_ref in zip(port, ref):
        assert len(e_port) == len(e_ref) == 2
        for (ids, x, y), (ids_r, x_r, y_r) in zip(e_port, e_ref):
            assert ids == ids_r
            assert x.shape[:2] == (2, 4) and y.shape[:2] == (2, 3) and y.dtype == np.uint8
            assert x.shape[2:] == ((16, 16, 16) if random_tail else (20, 22, 18))  # cropped, or the whole head
            np.testing.assert_array_equal(x, x_r)
            np.testing.assert_array_equal(y, y_r)


def test_datalist_folds_partition_and_kfold(tmp_path):
    """Fold selection, the per-process partition and the stratified k-fold assignment equal the JAX package's."""
    datalist = write_cases(tmp_path, 5, ftt.save_nifti, folds=3)
    for section in ("training", "validation"):
        got = ftt.load_decathlon_datalist(datalist, section=section, fold=1, base_dir=tmp_path / "data")
        assert got == jax_data.load_decathlon_datalist(datalist, section=section, fold=1, base_dir=tmp_path / "data")
    assert [x["fold"] for x in ftt.load_decathlon_datalist(datalist, section="validation", fold=1)] == [1, 1]
    items = list(range(11))
    assert [ftt.partition_datalist(items, 3, i) for i in range(3)] == [jax_data.partition_datalist(items, 3, i) for i in range(3)]
    values = np.random.default_rng(0).gamma(2.0, 10.0, size=40)
    folds = ftt.stratified_kfold(values, num_folds=5)
    assert folds == jax_data.stratified_kfold(values, num_folds=5) and sorted(set(folds)) == [0, 1, 2, 3, 4]


def test_persistent_dataset_reuses_its_cache(tmp_path):
    """PersistentDataset writes the deterministic output once and a second instance reads it back unchanged."""
    datalist = write_cases(tmp_path, 2, ftt.save_nifti, seed=6)
    items = ftt.load_decathlon_datalist(datalist, base_dir=tmp_path / "data")
    det, _ = yaml_transforms(port_T)
    first = ftt.PersistentDataset(items, transform=det, cache_dir=tmp_path / "cache")
    a = first[1]
    assert len(list((tmp_path / "cache").glob("*.pkl"))) == 1

    def refuse(item):
        raise AssertionError("the cache was not used")

    b = ftt.PersistentDataset(items, transform=refuse, cache_dir=tmp_path / "cache")[1]
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("processes", [False, True])
def test_worker_error_reaches_the_consumer(processes):
    """A transform that raises in a worker raises in the loop that reads the loader, and does not hang it."""

    def bad(d):
        raise ValueError("corrupt case")

    data = [{"x": np.zeros((2,), np.float32), "id": f"c{i}"} for i in range(4)]
    loader = ftt.DataLoader(ftt.Dataset(data, transform=bad), batch_size=2, num_workers=1, use_processes=processes)
    with pytest.raises(RuntimeError, match="worker failed"):
        list(loader)


def test_case_generator_is_brats_like():
    """The synthetic cases have a zero background, four modalities and the labels {0, 1, 2, 3}."""
    images, label = brats_case(np.random.default_rng(0))
    assert len(images) == 4 and all(im.dtype == np.float32 for im in images)
    assert set(np.unique(label)) == {0, 1, 2, 3}
    assert (images[0][0] == 0).all() and (images[0] != 0).mean() > 0.3
