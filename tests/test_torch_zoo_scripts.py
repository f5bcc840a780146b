"""The bundle programs on the port against the JAX package's: ``evaluate_bundle``, ``ensemble_inference``,
``fuse_brats_labels`` and ``load_model_checkpoint``, from JAX (orbax) checkpoints exported with
``tools/export_jax_checkpoint.py``.

Two synthetic single-channel 16^3 cases are written as NIfTI files; a tiny
Factorizer (widths 4 and 8) gets two JAX checkpoints (``init`` from keys 0
and 1, each head bias set so that about half the voxels come out positive,
so the masks are not trivial); the export tool writes each as ``.npz``.
Then both packages' programs run on the same files: the port on the CPU
(``device="cpu"``), where the kernels' wrappers take their plain versions.
A reduced JAX ``DynUNet``'s checkpoint goes through the same export into the
port's ``DynUNet``.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import factorizer_tpu as ftx
from factorizer_tpu import zoo_scripts as jax_zoo
from factorizer_tpu.data import DataLoader as JaxDataLoader
from factorizer_tpu.data import Dataset as JaxDataset
from factorizer_tpu.data import transforms as jax_T
from factorizer_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from factorizer_tpu.train.trainer import create_train_state as jax_create_train_state

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch import zoo_scripts
from factorizer_tpu_torch.data import transforms as port_T
from factorizer_tpu_torch.train.sliding_window import sliding_window_inference
from factorizer_tpu_torch.train.trainer import create_train_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import export_jax_checkpoint  # noqa: E402

torch.set_num_threads(1)

SP = (16, 16, 16)
MODEL = dict(in_channels=1, out_channels=1, spatial_size=SP, encoder_depth=(1, 1), encoder_width=(4, 8), strides=(1, 2),
             decoder_depth=(1,), rank=1, num_iters=2, init_method="uniform", solver="hals", mlp_ratio=2)
SW = {"head_dim": 2, "patch_size": 4, "shifts": [None, 2]}


def _jax_model():
    return ftx.Factorizer(**MODEL, reshape=(ftx.SWMatricize, SW))


def _port_model():
    return ftt.Factorizer(**MODEL, reshape=(ftt.SWMatricize, SW), device="cpu")


def _balanced_state(model, key: int, image: np.ndarray):
    """A JAX train state from ``init`` with ``key``, its head bias moved so that the median logit on ``image`` is 0."""
    state = jax_create_train_state(model, optax.adamw(1e-3), np.zeros((1, 1, *SP), np.float32), jax.random.key(key),
                                   {"train": False})
    logits = model.apply({"params": state.params, "buffers": state.buffers}, jnp.asarray(image))
    params = jax.tree.map(lambda a: a, state.params)
    head = params["unet"]["head"]["conv"]
    head["bias"] = head["bias"] - jnp.median(logits)
    return state.replace(params=params)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zoo_scripts")
    rng = np.random.default_rng(0)
    data_dir = tmp / "data"
    items = []
    for i in range(2):
        case = data_dir / f"c{i}"
        case.mkdir(parents=True)
        image = (rng.random(SP) + 0.1).astype(np.float32)
        label = np.zeros(SP, np.uint8)
        label[4:12, 3:11, 5:13] = 1
        ftt.save_nifti(case / "img.nii.gz", image)
        ftt.save_nifti(case / "seg.nii.gz", label)
        items.append({"id": f"c{i}", "image": f"c{i}/img.nii.gz", "label": f"c{i}/seg.nii.gz", "fold": 0})
    datalist = tmp / "datalist.json"
    datalist.write_text(json.dumps({"training": items, "test": items}))

    model = _jax_model()
    first = ftt.load_nifti(data_dir / "c0" / "img.nii.gz").data[None, None]
    ckpts, npzs = [], []
    for fold in range(2):
        ckpt = tmp / "jax_models" / f"fold{fold}"
        jax_save_checkpoint(ckpt, _balanced_state(model, fold, first))
        npz = tmp / "models" / f"fold{fold}.npz"
        export_jax_checkpoint.export(ckpt, npz)
        ckpts.append(ckpt)
        npzs.append(npz)
    return {"tmp": tmp, "data_dir": data_dir, "datalist": datalist, "items": items, "ckpts": ckpts, "npzs": npzs}


def _loader(pkg_T, dataset, data_loader, b):
    pre = pkg_T.Compose([
        pkg_T.LoadImaged(["image"], ensure_channel_first=True),
        pkg_T.LoadImaged(["label"], dtype=np.uint8, ensure_channel_first=True),
        pkg_T.SpatialPadd(["image", "label"], spatial_size=SP),
    ])
    items = [{**it, "image": str(b["data_dir"] / it["image"]), "label": str(b["data_dir"] / it["label"])} for it in b["items"]]
    return data_loader(dataset(items, pre), batch_size=1, num_workers=0)


def _masks(directory: Path) -> dict:
    return {p.name: ftt.load_nifti(p).data for p in sorted(directory.glob("*.nii.gz"))}


def test_export_tool_writes_every_leaf(bundle):
    """The ``.npz`` holds every ``params`` and ``buffers`` leaf of the JAX checkpoint under its ``/``-joined path, and
    ``main`` writes the same file from the command line."""
    restored = jax_zoo.load_model_checkpoint(_jax_model(), bundle["ckpts"][0], SP)
    with np.load(bundle["npzs"][0]) as flat:
        keys = set(flat.files)
        np.testing.assert_array_equal(flat["params/unet/head/conv/bias"], restored["params"]["unet"]["head"]["conv"]["bias"])
    want = set(export_jax_checkpoint.flatten({k: restored[k] for k in ("params", "buffers")}))
    assert keys == want and any(k.startswith("buffers/") for k in keys)
    again = bundle["tmp"] / "again.npz"
    export_jax_checkpoint.main([str(bundle["ckpts"][0]), str(again)])
    with np.load(again) as a, np.load(bundle["npzs"][0]) as b:
        assert sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)


def test_evaluate_bundle_matches_jax(bundle):
    """``evaluate_bundle`` from the exported weights against the JAX program from its checkpoint, on the same files:
    mean Dice and HD95 (and every case's) to 1e-5 absolute, the same files written (``case_metrics.json``, the
    metric CSVs, one prediction per case at the native shape), the saved masks equal in at least 99.9 % of voxels."""
    outs = []
    for name, program, ckpt, loader, kw in (
        ("port", zoo_scripts.evaluate_bundle, bundle["npzs"][0], _loader(port_T, ftt.Dataset, ftt.DataLoader, bundle),
         {"device": "cpu"}),
        ("jax", jax_zoo.evaluate_bundle, bundle["ckpts"][0], _loader(jax_T, JaxDataset, JaxDataLoader, bundle), {}),
    ):
        out = bundle["tmp"] / f"eval_{name}"
        model = _port_model() if name == "port" else _jax_model()
        metrics = program(model, ckpt, loader, roi_size=SP, output_dir=str(out / "preds"),
                          case_metrics_path=str(out / "case_metrics.json"), channel_names=["fg"], **kw)
        outs.append((metrics, json.loads((out / "case_metrics.json").read_text()), out))
    (metrics, cases, out), (metrics_j, cases_j, out_j) = outs
    assert metrics.keys() == metrics_j.keys() == {"mean_dice", "dice_fg", "hd95"}
    assert 0.0 < metrics["mean_dice"] < 1.0 and np.isfinite(metrics["hd95"])
    for key in metrics:
        assert abs(metrics[key] - metrics_j[key]) <= 1e-5, key
    for case, case_j in zip(cases["cases"], cases_j["cases"]):
        assert case["id"] == case_j["id"]
        np.testing.assert_allclose(case["dice"] + case["hd95"], case_j["dice"] + case_j["hd95"], rtol=0, atol=1e-5)
    assert sorted(p.name for p in (out / "metrics").iterdir()) == sorted(p.name for p in (out_j / "metrics").iterdir())
    masks, masks_j = _masks(out / "preds"), _masks(out_j / "preds")
    assert masks.keys() == masks_j.keys() and len(masks) == 2
    for name, mask in masks.items():
        assert mask.shape == SP and (mask == masks_j[name]).mean() >= 0.999


def _port_probabilities(item: dict, data_dir: Path, model: torch.nn.Module, states: list) -> np.ndarray:
    """The mean of the fold models' sigmoids on ``item``, through the port's inference preprocessing, inverted to the
    native grid."""
    d = zoo_scripts._inference_preprocessing(SP, (1.0, 1.0, 1.0))(
        {**item, "image": str(data_dir / item["image"]), "label": str(data_dir / item["label"])})
    image = torch.as_tensor(d["image"])[None]
    probs = 0
    with torch.no_grad():
        for state in states:
            model.load_state_dict(state)
            probs = probs + torch.sigmoid(sliding_window_inference(image, SP, model, sw_batch_size=2, overlap=0.5))
    d["pred"] = (probs / len(states))[0].numpy()
    return port_T.Invertd(["pred"], orig_keys="image")(d)["pred"][0]


def test_ensemble_inference_matches_jax(bundle):
    """``ensemble_inference`` over 2 folds from the exported weights against the JAX program over the 2 checkpoints:
    the same files, each mask equal in at least 99.9 % of voxels, and where they differ the port's mean
    probability is within 1e-4 of 0.5 (the threshold's own ambiguity at float32)."""
    common = dict(datalist_path=str(bundle["datalist"]), data_dir=str(bundle["data_dir"]), roi_size=SP,
                  pix_size=(1.0, 1.0, 1.0), section="test")
    out, out_j = bundle["tmp"] / "ens_port", bundle["tmp"] / "ens_jax"
    saved = zoo_scripts.ensemble_inference(_port_model(), [str(p) for p in bundle["npzs"]], output_dir=str(out),
                                           device="cpu", **common)
    saved_j = jax_zoo.ensemble_inference(_jax_model(), [str(p) for p in bundle["ckpts"]], output_dir=str(out_j), **common)
    assert [Path(p).name for p in saved] == [Path(p).name for p in saved_j] == ["c0_pred.nii.gz", "c1_pred.nii.gz"]
    model = _port_model()
    states = [zoo_scripts.load_model_checkpoint(model, p) for p in bundle["npzs"]]
    for path, path_j, item in zip(saved, saved_j, bundle["items"]):
        mask, mask_j = ftt.load_nifti(path).data, ftt.load_nifti(path_j).data
        assert mask.shape == SP and 0 < mask.mean() < 1
        differ = mask != mask_j
        assert differ.mean() <= 1e-3
        probs = _port_probabilities(item, bundle["data_dir"], model, states)
        np.testing.assert_array_equal(mask, (probs > 0.5).astype(mask.dtype))
        assert (np.abs(probs[differ] - 0.5) < 1e-4).all()


def test_fuse_brats_labels_matches_jax():
    """The BraTS fusion of nested (ET, TC, WT) masks equals the JAX package's exactly."""
    rng = np.random.default_rng(3)
    wt = rng.random((12, 10, 8)) > 0.4
    tc = wt & (rng.random(wt.shape) > 0.4)
    et = tc & (rng.random(wt.shape) > 0.4)
    pred = np.stack([et, tc, wt]).astype(np.uint8)
    fused = zoo_scripts.fuse_brats_labels(pred)
    np.testing.assert_array_equal(fused, jax_zoo.fuse_brats_labels(pred))
    assert fused.dtype == np.uint8 and set(np.unique(fused)) == {0, 1, 2, 3}


def test_load_model_checkpoint_reads_every_layout(bundle, tmp_path):
    """A trainer's ``ckpt_dir`` (its newest ``step_<n>.pt``), one ``.pt`` of a train state or of a ``state_dict``, and an
    exported ``.npz``: each gives the ``state_dict`` it holds, and the shared model is left as it was."""
    model = _port_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    states = []
    manager = ftt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for seed in (1, 2):
        state = create_train_state(ftt.Factorizer(**MODEL, reshape=(ftt.SWMatricize, SW), device="cpu",
                                                  generator=torch.Generator().manual_seed(seed)), device="cpu", lr=1e-3)
        manager.save(seed, state)
        states.append({k: v.clone() for k, v in state.model.state_dict().items()})
    ftt.save_checkpoint(tmp_path / "state.pt", state)
    ftt.save_checkpoint(tmp_path / "weights.pt", state.model)
    want_npz = ftt.load_flax_variables(_port_model(), jax_zoo.load_model_checkpoint(_jax_model(), bundle["ckpts"][1], SP))
    for path, want in ((tmp_path / "ckpt", states[1]), (tmp_path / "state.pt", states[1]),
                       (tmp_path / "weights.pt", states[1]), (bundle["npzs"][1], want_npz.state_dict())):
        got = zoo_scripts.load_model_checkpoint(model, path)
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), (path, key)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    other = ftt.Factorizer(**{**MODEL, "encoder_width": (4, 16)}, reshape=(ftt.SWMatricize, SW), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        zoo_scripts.load_model_checkpoint(other, tmp_path / "weights.pt")
    with pytest.raises(FileNotFoundError, match="export_jax_checkpoint"):
        zoo_scripts.load_model_checkpoint(model, bundle["ckpts"][0])


def test_aot_compile_raises_on_the_cpu(bundle):
    """``aot_compile=True`` replays a CUDA graph: on the CPU it raises instead of running eagerly."""
    with pytest.raises(ValueError, match="CUDA graph"):
        zoo_scripts.ensemble_inference(_port_model(), [str(bundle["npzs"][0])], str(bundle["datalist"]),
                                       str(bundle["data_dir"]), SP, (1.0, 1.0, 1.0), str(bundle["tmp"] / "aot"),
                                       aot_compile=True, device="cpu")
    assert not (bundle["tmp"] / "aot").exists()


def test_jax_dynunet_checkpoint_loads_into_the_port(tmp_path):
    """A reduced JAX ``DynUNet``'s train state saved as an orbax checkpoint and exported with
    ``tools/export_jax_checkpoint.py``: ``load_model_checkpoint`` reads the ``.npz`` into the port's ``DynUNet`` (the
    bridge uses every Flax leaf) and the port's logits equal JAX's to 1e-5 of the largest, in float32."""
    cfg = dict(in_channels=2, out_channels=3, kernel_size=(3, 3, 3), strides=(1, 2, 2), filters=(4, 8, 16))
    model_j = ftx.DynUNet(**cfg)
    state = jax_create_train_state(model_j, optax.adamw(1e-3), np.zeros((1, 2, *SP), np.float32), jax.random.key(3),
                                   {"train": False})
    jax_save_checkpoint(tmp_path / "jax_ckpt", state)
    flat = export_jax_checkpoint.export(tmp_path / "jax_ckpt", tmp_path / "dynunet.npz")
    assert flat and all(k.startswith("params/") for k in flat)
    model_t = ftt.DynUNet(**cfg, device="cpu")
    weights = zoo_scripts.load_model_checkpoint(model_t, tmp_path / "dynunet.npz")
    assert weights.keys() == model_t.state_dict().keys()
    model_t.load_state_dict(weights)
    x = np.random.default_rng(7).standard_normal((2, 2, *SP)).astype(np.float32)
    want = np.asarray(jax.jit(model_j.apply)({"params": state.params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, *SP)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
