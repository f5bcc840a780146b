"""The system under test, ``factorizer_tpu_torch``, as the benchmark drives it: the only module here that imports it.

From the program the benchmark takes its networks (built through its
``ConfigParser`` from a configuration's unedited ``network_def``), its train
step (``train.trainer.make_train_step`` with DiceCE and AdamW), its served
entry (``zoo_scripts.ensemble_predict``) and the launch counters of its kernel
wrappers that the kernel files under ``kernels/`` name.  The networks' tensors, the inputs and every yardstick are the
benchmark's own.
"""

from __future__ import annotations

import copy
import importlib

import torch

from factorizer_tpu_torch.config import ConfigParser
from factorizer_tpu_torch.ops.kernels import build
from factorizer_tpu_torch.train.trainer import create_train_state, make_train_step
from factorizer_tpu_torch.utils.helpers import materialize
from factorizer_tpu_torch.zoo_scripts import ensemble_predict


def build_network(config: dict, device) -> torch.nn.Module:
    """The configuration's ``network_def`` through the program's ``ConfigParser``, on ``device``."""
    cfg = copy.deepcopy(config)
    cfg["network_def"]["device"] = str(device)
    parser = ConfigParser(cfg)
    parser.seed(cfg["seed"])
    return materialize(parser["network_def"], len(cfg["roi_size"]))


def load_kernels() -> float | None:
    """Build or load the program's kernel library (``factorizer_tpu_torch/build/``); the seconds a build took,
    None where an identical build was there."""
    build.library()
    return build.build_info()[0]


def train_state(model: torch.nn.Module, lr: float, weight_decay: float):
    """The program's train state (fused AdamW at a constant ``lr``) and its step, with the default DiceCE loss."""
    state = create_train_state(model, device=next(model.parameters()).device, lr=lr, weight_decay=weight_decay)
    return state, make_train_step(state.model)


def first_moments(state) -> dict:
    """name -> AdamW's first moment of every parameter that has one."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: s["exp_avg"] for p, s in state.optimizer.state.items() if "exp_avg" in s}


def serve(models, image: torch.Tensor, roi, sw_batch: int, overlap: float):
    """``(mask, probs)`` of the fold ensemble over ``image`` on the card."""
    return ensemble_predict(models, image, roi, sw_batch, overlap)


def read_counters(counters: dict) -> dict:
    """name -> the program's counter at ``"module:object.attribute"`` for each entry of ``counters`` (a kernel
    file's ``COUNTERS``: its wrappers' ``launches``, as ``chip_smoke.py::kernel_counters`` at commit ef50548 reads
    them)."""
    out = {}
    for name, where in counters.items():
        module, path = where.split(":")
        obj = importlib.import_module(module)
        for attr in path.split("."):
            obj = getattr(obj, attr)
        out[name] = obj
    return out
