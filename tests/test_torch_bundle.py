"""The bundles' YAML programs on the port: ``factorizer_tpu_torch.config`` (parser, overlays, CLI) against the JAX package's.

Every bundle's files are read unedited from ``zoo/<bundle>/configs``.  All
twelve bundles build their transforms and their overlays.  The five
Factorizer / Deconver bundles build their ``network_def`` as the zoo factory
does (the same weights from the same seed, ``amp`` and a ``dtype`` override);
the seven baseline bundles (``nnunet_*``: DynUNet, ``segresnet_*``: SegResNet,
``swinunetr_isles22``: SwinUNETR) build theirs at a reduced override in both
packages and, with the JAX weights bridged, give the JAX logits;
``segresnet_fives`` builds a 2-D network.  The port-parsed loader gives the
JAX-parsed loader's batches bit for bit; the CLI's override forms and
``main()`` are the JAX package's tests ported; 2-epoch runs on the CPU of
``factorizer_brats23`` at 16^3 and ``segresnet_fives`` at 32^2 repeat their
losses from the config's ``seed``; resolving ``evaluate.yaml``'s program
imports nothing of JAX; and reduced float16 models built from
``network_def#dtype=$jnp.float16`` match the JAX package's ``jnp.float16``
models with the same weights.
Everything runs on the CPU (``network_def#device=cpu`` and the like), where
the kernels' wrappers take their plain versions.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from factorizer_tpu import config as jax_config

import factorizer_tpu_torch as ftt
from factorizer_tpu_torch import zoo_scripts
from factorizer_tpu_torch.config import ConfigParser, run
from factorizer_tpu_torch.config.bundle import _normalize_cli_overrides, main
from factorizer_tpu_torch.parallel.slabs import Cut
from torch_bundle_cases import (
    NNUNET_SMALL, ON_CPU, REPO, SEGRESNET_SMALL, SWINUNETR_SMALL, TINY_DECONVER, TINY_FACTORIZER, ZOO, bundle_config,
)
from torch_workflow_cases import write_cases

torch.set_num_threads(1)

PORTED = {
    "factorizer_brats23": ftt.brats23_network,
    "factorizer_isles22": ftt.factorizer_isles22_network,
    "deconver_brats23": ftt.deconver_brats23_network,
    "deconver_isles22": ftt.deconver_isles22_network,
    "deconver_fives": ftt.deconver_fives_network,
}
# The baseline bundles: the class each network_def names, a reduced override of it, and the input shape.
BASELINES = {
    "nnunet_brats23": ("DynUNet", NNUNET_SMALL, (1, 4, 16, 16, 16)),
    "nnunet_fives": ("DynUNet", NNUNET_SMALL, (1, 3, 32, 32)),
    "nnunet_isles22": ("DynUNet", NNUNET_SMALL, (1, 2, 16, 16, 16)),
    "segresnet_brats23": ("SegResNet", SEGRESNET_SMALL, (1, 4, 16, 16, 16)),
    "segresnet_fives": ("SegResNet", SEGRESNET_SMALL, (1, 3, 32, 32)),
    "segresnet_isles22": ("SegResNet", SEGRESNET_SMALL, (1, 2, 16, 16, 16)),
    # img_size is @roi_size: stages of 16^3 and 8^3 (window 7, padded, shifted), 4^3 and 2^3 (clamped)
    "swinunetr_isles22": ("SwinUNETR", SWINUNETR_SMALL, (1, 2, 32, 32, 32)),
}
BUNDLES = sorted(PORTED) + sorted(BASELINES)
# The overlays as the bundles' docs/*.sh stack them over train.yaml; inference_aot.yaml goes over inference.yaml.
OVERLAYS = [("train_multidevice.yaml",), ("evaluate.yaml",), ("inference.yaml",), ("inference.yaml", "inference_aot.yaml")]


@pytest.mark.parametrize("bundle", list(PORTED))
def test_network_def_builds_the_zoo_factory_model(bundle):
    """``network_def`` from the port's parser, on the CPU, after ``torch.manual_seed(0)``: the zoo factory's model
    from a generator seeded 0, every parameter and buffer equal, in float32 as ``amp: false`` ships it.  The parser
    resolves ``$ftx.<Name>`` to the port's classes and ``$jnp.bfloat16 if @amp else None`` to None."""
    parser = ConfigParser(bundle_config(bundle, **{"network_def#device": "cpu"}))
    torch.manual_seed(0)
    model = parser["network_def"]
    factory = PORTED[bundle](device="cpu", generator=torch.Generator().manual_seed(0))
    assert type(model) is type(factory) and model.stem.dtype is None
    sd, want = model.state_dict(), factory.state_dict()
    assert sd.keys() == want.keys()
    for key in want:
        assert torch.equal(sd[key], want[key]), key


@pytest.mark.parametrize("bundle", ["factorizer_brats23", "deconver_fives"])
def test_amp_and_dtype_overrides(bundle):
    """``amp: true`` gives a bfloat16 network, ``network_def#dtype=$jnp.float16`` a float16 one; another ``jnp``
    attribute raises, naming the port."""
    small = TINY_FACTORIZER if bundle.startswith("factorizer") else {}
    base = {"network_def#device": "cpu", **small}
    assert ConfigParser(bundle_config(bundle, amp=True, **base))["network_def"].stem.dtype == torch.bfloat16
    assert ConfigParser(bundle_config(bundle, **{"network_def#dtype": "$jnp.float16"}, **base))["network_def"].stem.dtype == torch.float16
    with pytest.raises(AttributeError, match="factorizer_tpu_torch"):
        ConfigParser(bundle_config(bundle, **{"network_def#dtype": "$jnp.int8"}, **base))["network_def"]


@pytest.mark.parametrize("bundle", BUNDLES)
def test_transforms_build_with_the_random_tail(bundle):
    """The train preprocessing is the deterministic list with the random tail after it; validation has no tail."""
    parser = ConfigParser(bundle_config(bundle))
    train, val = parser["train_preprocessing"], parser["val_preprocessing"]
    assert len(train.transforms) > len(val.transforms)
    assert [type(t) for t in train.transforms[: len(val.transforms)]] == [type(t) for t in val.transforms]
    assert all(isinstance(t, ftt.transforms.RandomizableTransform) for t in train.transforms[len(val.transforms):])


@pytest.mark.parametrize("bundle", BUNDLES)
def test_overlays_parse_and_name_the_port(bundle):
    """Each overlay merges over train.yaml; its program's ``_target_`` (``factorizer_tpu.zoo_scripts.*``,
    ``factorizer_tpu.parallel.mesh.data_parallel_mesh``) is read in the port; ``inference_aot.yaml`` sets
    ``aot_compile``; ``sharded_train_datalist`` is the whole training list in one process."""
    for overlays in OVERLAYS:
        cfg = bundle_config(bundle, *overlays)
        parser = ConfigParser(cfg)
        overlay = overlays[-1]
        if overlay == "train_multidevice.yaml":
            from factorizer_tpu_torch.parallel.mesh import data_parallel_mesh

            assert parser._lookup(cfg["mesh"]["_target_"]) is data_parallel_mesh
            assert parser["sharded_train_datalist"] == parser["train_datalist"] and parser["train_datalist"]
            assert parser["train_dataset"].data == parser["sharded_train_datalist"]
        elif overlay == "evaluate.yaml":
            assert parser._lookup(cfg["evaluator"]["_target_"]) is zoo_scripts.evaluate_bundle
            assert parser["ckpt_path"] == str(ZOO / bundle) + "/models/fold0"
        else:
            assert parser._lookup(cfg["inferencer"]["_target_"]) is zoo_scripts.ensemble_inference
            assert cfg["inferencer"].get("aot_compile", False) is (overlay == "inference_aot.yaml")
            assert parser["ckpt_paths"] == []  # no models/fold* in the repository


@pytest.mark.parametrize("bundle", sorted(BASELINES))
def test_baseline_network_def_matches_jax(bundle):
    """The baseline bundles' ``network_def`` from both parsers at a reduced override: the port's class of the same
    name, on the CPU, in float32 as ``amp: false`` ships it; with the JAX weights (``init`` from key 0) bridged, its
    logits equal the JAX model's to 1e-4 of the largest.  ``segresnet_fives``, whose ``network_def`` names no rank,
    builds a 2-D network at its first 2-D batch, as the JAX model does at ``init``."""
    name, overrides, shape = BASELINES[bundle]
    model_j = jax_config.ConfigParser(bundle_config(bundle, **overrides))["network_def"]
    model_t = ConfigParser(bundle_config(bundle, **overrides, **{"network_def#device": "cpu"}))["network_def"]
    assert type(model_t) is getattr(ftt, name) and type(model_j).__name__ == name
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    variables = jax.tree.map(np.asarray, dict(jax.jit(model_j.init)(jax.random.key(0), jnp.asarray(x))))
    with torch.no_grad():
        model_t(torch.from_numpy(x))  # builds a SegResNet at the input's rank
    ftt.load_flax_variables(model_t, variables)
    assert next(model_t.parameters()).device.type == "cpu"
    if bundle.endswith("fives"):
        assert next(model_t.parameters()).ndim == 4  # (O, I, kh, kw): 2-D convolutions
    want = np.asarray(jax.jit(model_j.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (shape[0], 3 if bundle.endswith("brats23") else 1, *shape[2:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_jax_only_targets_raise_by_name():
    """``train_tp.yaml``'s ``model_parallel_mesh`` resolves to the port's (a mesh of one in one process); its spatial
    step is taken for ``factorizer_brats23`` and ``deconver_brats23``, and for the Deconver with ``update_filter``
    (its filter update sums the slabs' correlations, every level on slabs); a ``_target_`` in JAX's own packages is
    refused before any import."""
    from factorizer_tpu_torch.parallel.mesh import model_parallel_mesh

    cfg = bundle_config("factorizer_brats23", "train_tp.yaml", **TINY_FACTORIZER, **ON_CPU)
    parser = ConfigParser(cfg)
    assert parser._lookup(cfg["mesh"]["_target_"]) is model_parallel_mesh
    assert dict(parser["mesh"].shape) == {"data": 1, "model": 1}
    axis = cfg["trainer"]["model_axis"]
    assert axis == "model" and cfg["trainer"]["shard_spatial"] is True
    ftt.make_train_step(parser["network_def"], mesh=parser["mesh"], spatial_axis=axis)
    deconver = ConfigParser(bundle_config("deconver_brats23", "train_tp.yaml", **TINY_DECONVER, **ON_CPU))
    ftt.make_train_step(deconver["network_def"], mesh=deconver["mesh"], spatial_axis=axis)
    filters = ConfigParser(bundle_config("deconver_brats23", "train_tp.yaml", **TINY_DECONVER, **ON_CPU,
                                         **{"network_def#update_filter": True}))
    assert filters["network_def"].slab_path_missing() is None
    assert filters["network_def"].slab_route(Cut.equal(32, 2)).level is None
    ftt.make_train_step(filters["network_def"], mesh=filters["mesh"], spatial_axis=axis)
    with pytest.raises(KeyError, match="optax.adamw"):
        ConfigParser({"x": {"_target_": "optax.adamw"}})["x"]


def _data_overrides(root: Path, datalist: Path) -> dict:
    return {"data_dir": str(root / "data"), "datalist_path": str(datalist), "num_workers": 0}


def test_port_parsed_loader_matches_jax_parsed(tmp_path):
    """``train_dataloader`` parsed by each package from the same files (roi 16^3, main-thread loader): with the
    transform chain seeded alike, one epoch's batches are equal bit for bit."""
    datalist = write_cases(tmp_path, 5, ftt.save_nifti, seed=4, folds=5)
    overrides = {**_data_overrides(tmp_path, datalist), "roi_size": [16, 16, 16]}
    epochs = []
    for parser in (ConfigParser(bundle_config("factorizer_brats23", **overrides)),
                   jax_config.ConfigParser(bundle_config("factorizer_brats23", **overrides))):
        parser["train_preprocessing"].set_random_state(17)
        epochs.append([(b["id"], b["image"], b["label"]) for b in parser["train_dataloader"]])
    port, ref = epochs
    assert len(port) == len(ref) == 2
    for (ids, x, y), (ids_r, x_r, y_r) in zip(port, ref):
        assert ids == ids_r and x.shape == (2, 4, 16, 16, 16) and y.dtype == np.uint8
        np.testing.assert_array_equal(x, x_r)
        np.testing.assert_array_equal(y, y_r)


def test_cli_override_forms():
    """The CLI takes positional ``key=value`` and the reference's ``--key value`` / ``--key=value`` forms."""
    got = _normalize_cli_overrides(["a=1", "--max_epochs", "5", "--roi_size=[16,16,16]", "--network_def#solver", "hals"])
    assert got == ["a=1", "max_epochs=5", "roi_size=[16,16,16]", "network_def#solver=hals"]
    with pytest.raises(SystemExit):
        _normalize_cli_overrides(["--dangling"])


def test_cli_main_runs_program(tmp_path):
    """``main()`` (``python -m factorizer_tpu_torch.bundle``) runs a tiny program with mixed-form overrides."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text("x: 1\nmsg: $str(@x) + '-' + str(@y)\nout_file: null\nrun: [\"$open(@out_file, 'w').write(@msg)\"]\n")
    out = tmp_path / "o.txt"
    main(["run", "--config_file", str(cfg), "--y", "7", f"out_file={out}"])
    assert out.read_text() == "1-7"
    with pytest.raises(SystemExit):
        main(["run"])


def test_expressions_see_registry_names():
    """``$``-expressions resolve registry helpers without module paths (``$partition_datalist(...)``)."""
    parser = ConfigParser({"items": [1, 2, 3, 4], "shard": "$partition_datalist(@items, 2, 0)"})
    assert parser["shard"] == [1, 3]


def test_cli_trains_factorizer_brats23_the_same_twice(tmp_path):
    """``train.yaml`` through ``run`` at 16^3 on the CPU: 2 epochs of 2 steps, a validation at epoch 2, the
    checkpoint ``step_2.pt`` (the trainers number checkpoints by epoch, as the JAX trainer does);
    a second run from the same ``seed`` repeats every epoch loss and the validation bit for bit (the seed draws
    the weights when ``network_def`` is built and seeds the transform chains)."""
    datalist = write_cases(tmp_path, 5, ftt.save_nifti, seed=8, folds=5)
    overrides = {**_data_overrides(tmp_path, datalist), **TINY_FACTORIZER, **ON_CPU, "max_epochs": 2,
                 "val_interval": 2}
    histories = []
    for i in range(2):
        parser = run(str(ZOO / "factorizer_brats23" / "configs" / "train.yaml"), output_dir=str(tmp_path / f"run{i}"),
                     **overrides)
        trainer = parser["trainer"]
        assert trainer.state.step == 4 and (tmp_path / f"run{i}" / "ckpt" / "step_2.pt").is_file()
        assert next(trainer.model.parameters()).device.type == "cpu"
        histories.append([{k: v for k, v in h.items() if k != "time_s"} for h in trainer.history])
    assert histories[0] == histories[1]
    assert all(np.isfinite(h["loss"]) for h in histories[0]) and 0.0 <= histories[0][-1]["mean_dice"] <= 1.0


def _fives_pngs(root: Path, n: int = 4) -> Path:
    """``n`` FIVES-layout cases of raw 64^2 PNGs (an RGB image, a square vessel mask) and their datalist."""
    from PIL import Image

    rng = np.random.default_rng(0)
    items = []
    for folder in ("Original", "Ground truth"):
        (root / "train" / folder).mkdir(parents=True)
    for i in range(n):
        name = f"{i + 1}_A.png"
        label = np.zeros((64, 64), np.uint8)
        label[16:48, 16:48] = 255
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(root / "train" / "Original" / name)
        Image.fromarray(label).save(root / "train" / "Ground truth" / name)
        items.append({"id": f"train/Original_{i + 1}_A", "image": f"train/Original/{name}",
                      "label": f"train/Ground truth/{name}", "fold": i % 2})
    datalist = root / "datalist.json"
    datalist.write_text(json.dumps({"training": items, "test": []}))
    return datalist


def test_cli_trains_segresnet_fives_in_2d_the_same_twice(tmp_path):
    """``segresnet_fives``'s ``train.yaml`` through ``run`` on raw PNGs at 32^2, a reduced SegResNet, on the CPU:
    the trainer builds the network 2-D from ``roi_size`` (the file names no rank); 2 epochs with a validation at
    epoch 2; a second run from the same ``seed`` repeats every epoch loss and the validation bit for bit."""
    datalist = _fives_pngs(tmp_path / "data")
    overrides = {"data_dir": str(tmp_path / "data"), "datalist_path": str(datalist), "num_workers": 0,
                 "roi_size": [32, 32], "batch_size": 2, "max_epochs": 2, "val_interval": 2, **SEGRESNET_SMALL, **ON_CPU}
    histories = []
    for i in range(2):
        parser = run(str(ZOO / "segresnet_fives" / "configs" / "train.yaml"), output_dir=str(tmp_path / f"run{i}"),
                     **overrides)
        trainer = parser["trainer"]
        assert trainer.state.step == 2 and (tmp_path / f"run{i}" / "ckpt" / "step_2.pt").is_file()
        assert trainer.model.spatial_dims == 2 and trainer.model.stem.weight.ndim == 4
        histories.append([{k: v for k, v in h.items() if k != "time_s"} for h in trainer.history])
    assert histories[0] == histories[1]
    assert all(np.isfinite(h["loss"]) for h in histories[0]) and 0.0 <= histories[0][-1]["mean_dice"] <= 1.0


def test_evaluate_program_imports_nothing_of_jax(tmp_path):
    """In a fresh interpreter, resolving ``evaluate.yaml``'s ``evaluator`` over a trained port checkpoint evaluates
    the case and leaves ``jax`` and ``factorizer_tpu`` out of ``sys.modules``."""
    datalist = write_cases(tmp_path, 2, ftt.save_nifti, seed=2, folds=2)
    model = ftt.Factorizer(in_channels=4, out_channels=3, spatial_size=(16, 16, 16), encoder_depth=(1, 1),
                           encoder_width=(8, 16), strides=(1, 2), decoder_depth=(1,), mlp_ratio=4,
                           reshape=(ftt.SWMatricize, {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}), rank=1,
                           num_iters=5, init_method="uniform", solver="hals", device="cpu")
    ftt.save_checkpoint(tmp_path / "fold0.pt", model)
    overrides = {**_data_overrides(tmp_path, datalist), **TINY_FACTORIZER, **ON_CPU,
                 "ckpt_path": str(tmp_path / "fold0.pt"), "output_dir": str(tmp_path / "eval")}
    configs = ZOO / "factorizer_brats23" / "configs"
    script = (
        "import json, sys\n"
        "from factorizer_tpu_torch.config import run\n"
        f"parser = run([{str(configs / 'train.yaml')!r}, {str(configs / 'evaluate.yaml')!r}], run_id=[], **json.loads(sys.argv[1]))\n"
        "metrics = parser['evaluator']\n"
        "assert 0.0 <= metrics['mean_dice'] <= 1.0, metrics\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'orbax', 'factorizer_tpu'))))\n"
    )
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    done = subprocess.run([sys.executable, "-c", script, json.dumps(overrides)], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=env)
    assert done.returncode == 0, done.stderr[-2000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "eval" / "case_metrics.json").is_file()
    assert sorted(p.name for p in (tmp_path / "eval" / "preds").iterdir()) == ["case0_pred.nii.gz"]


def _bridged_pair(bundle: str, overrides: dict, dtype: str):
    """The JAX model and the port model that the two parsers build from the same overrides, with the JAX model's
    weights (``init`` from key 0) loaded into the port model."""
    model_j = jax_config.ConfigParser(bundle_config(bundle, **overrides, **{"network_def#dtype": f"$jnp.{dtype}"}))["network_def"]
    model_t = ConfigParser(bundle_config(bundle, **overrides, **{"network_def#dtype": f"$jnp.{dtype}", "network_def#device": "cpu"}))["network_def"]
    variables = jax.tree.map(np.asarray, dict(jax.jit(model_j.init)(jax.random.key(0), jnp.zeros((1, 4, 16, 16, 16)))))
    ftt.load_flax_variables(model_t, variables)
    return model_j, variables, model_t


# float16 logits, port against JAX, relative to the largest |logit|: both compute each layer in float16 with
# float32 solves and statistics and round each layer's output once, at 2^-11 (4.9e-4) relative; the two orders of
# summation put the roundings on different sides, and the layers carry them to the head.  Measured on the CPU:
# 1.2e-3 (Factorizer) and 3.2e-3 (Deconver), the float16 models against their own float32 runs 0.8e-3 and 4.6e-3.
F16_RTOL = 2e-2


@pytest.mark.parametrize("bundle, overrides", [("factorizer_brats23", TINY_FACTORIZER), ("deconver_brats23", TINY_DECONVER)],
                         ids=["factorizer", "deconver"])
def test_float16_model_matches_jax(bundle, overrides):
    """``network_def#dtype=$jnp.float16`` on the reduced models in both packages, the JAX weights bridged: the
    port's float16 logits against the JAX ``jnp.float16`` logits within ``F16_RTOL`` of the largest, against the
    float32 models' within the same band, and finite."""
    x = np.random.default_rng(0).standard_normal((1, 4, 16, 16, 16)).astype(np.float32)
    logits = {}
    for dtype in ("float16", "float32"):
        model_j, variables, model_t = _bridged_pair(bundle, overrides, dtype)
        ref = np.asarray(jax.jit(model_j.apply)(variables, jnp.asarray(x)), np.float32)
        with torch.no_grad():
            got = model_t(torch.from_numpy(x)).float().numpy()
        assert got.shape == ref.shape == (1, 3, 16, 16, 16) and np.isfinite(got).all()
        logits[dtype] = got, ref
    (got, ref), (got32, _) = logits["float16"], logits["float32"]
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= F16_RTOL * scale
    assert np.abs(got - got32).max() <= F16_RTOL * np.abs(got32).max()


def test_dtype_codes_match_common_cuh():
    """The wrappers' dtype codes are the kernels' ``DType`` values in ``csrc/common.cuh``: float16 is ``kFloat16``;
    float64 has no code and raises by name."""
    import re

    from factorizer_tpu_torch.ops.kernels import build

    header = (build.CSRC_DIR / "common.cuh").read_text()
    codes = {name: int(value) for name, value in re.findall(r"k(Float32|BFloat16|Float16) = (\d+)", header)}
    assert codes == {"Float32": 0, "BFloat16": 1, "Float16": 2}
    for dtype, name in ((torch.float32, "Float32"), (torch.bfloat16, "BFloat16"), (torch.float16, "Float16")):
        assert build.dtype_code(dtype) == codes[name]
    with pytest.raises(TypeError, match="torch.float64"):
        build.dtype_code(torch.float64)
