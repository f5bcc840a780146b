"""Shared inputs of the bundle-program tests: the zoo's configs read and overlaid, reduced ``network_def`` overrides.

Not a test module: ``tests/test_torch_bundle.py`` and ``tests/test_torch_multidevice.py`` import it (it imports
nothing of JAX, so the multi-process tests' spawned workers can too).
"""

from pathlib import Path

from factorizer_tpu_torch.config import load_config_files, merge_config

REPO = Path(__file__).resolve().parents[1]
ZOO = REPO / "zoo"
ON_CPU = {"network_def#device": "cpu", "trainer#device": "cpu", "evaluator#device": "cpu", "inferencer#device": "cpu"}

# factorizer_brats23 at 16^3: two stages of widths 8 and 16, patches of 4^3, two shifts.
TINY_FACTORIZER = {
    "roi_size": [16, 16, 16],
    "network_def#encoder_depth": [1, 1],
    "network_def#encoder_width": [8, 16],
    "network_def#strides": [1, 2],
    "network_def#decoder_depth": [1],
    "network_def#reshape": ["$ftx.SWMatricize", {"head_dim": 4, "patch_size": 4, "shifts": [None, 2]}],
}
# deconver_brats23 at 16^3: two stages of widths 4 and 8.
TINY_DECONVER = {
    "roi_size": [16, 16, 16],
    "network_def#encoder_depth": [1, 1],
    "network_def#encoder_width": [4, 8],
    "network_def#strides": [1, 2],
    "network_def#decoder_depth": [1],
}
# The baselines' reduced overrides (SwinUNETR's is its roi: img_size is @roi_size).
NNUNET_SMALL = {"network_def#kernel_size": [3, 3, 3], "network_def#strides": [1, 2, 2], "network_def#filters": [4, 8, 16]}
SEGRESNET_SMALL = {"network_def#init_filters": 8, "network_def#blocks_down": [1, 1, 1], "network_def#blocks_up": [1, 1]}
SWINUNETR_SMALL = {"roi_size": [32, 32, 32], "network_def#feature_size": 12}


def bundle_config(bundle: str, *overlays: str, **overrides) -> dict:
    """``zoo/<bundle>/configs/train.yaml`` with ``overlays`` (file names beside it) and ``key#sub=value`` overrides merged
    over it in order, its ``bundle_root`` the bundle's directory."""
    configs = ZOO / bundle / "configs"
    cfg = load_config_files([configs / "train.yaml", *(configs / o for o in overlays)])
    cfg["bundle_root"] = str(ZOO / bundle)
    for key, value in overrides.items():
        cfg = merge_config(cfg, {key: value})
    return cfg
