"""Bundle runner CLI: ``python -m factorizer_tpu_torch.bundle run ...``.

PyTorch counterpart of ``factorizer_tpu/config/bundle.py``: loads one or more
YAML config files (later files overlay earlier ones), applies ``key=value``
CLI overrides, then resolves and executes the requested program ids in order.
The programs build and run on the card; the overrides the files already allow
name the CPU (``network_def#device=cpu``, ``trainer#device=cpu``,
``evaluator#device=cpu``, ``inferencer#device=cpu``).

A config's ``seed`` is what resolving it draws from (:meth:`ConfigParser.seed`):
torch's default generator is seeded with it before anything resolves, so
``network_def`` draws the same weights in every run, and each transform chain
it builds is seeded with it.  Two runs of one config with the same ``seed``
take the same first step (with ``num_workers: 0``; worker threads take items
in the order they finish).

Under ``torchrun`` (``python -m torch.distributed.run --nproc_per_node N -m
factorizer_tpu_torch.bundle run ...``) the CLI joins the process group that
the environment describes before it reads a config, so that
``train_multidevice.yaml``'s ``jax.process_count()`` / ``process_index()``
and the ``mesh`` it builds see all processes; each process takes its own card
when the host has one for each (NCCL), else all share card 0 (gloo), before
``network_def`` is built on the current card.  One process with no
``torchrun`` needs no group: its mesh is a mesh of one.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import torch.distributed as dist

from .parser import ConfigParser, load_config_files, merge_config, parse_override

__all__ = ["run", "main"]


def run(
    config_file: str | Sequence[str],
    run_id: str | Sequence[str] = "run",
    overrides: Optional[Sequence[str]] = None,
    **kwargs,
) -> ConfigParser:
    """Load config files, apply overrides, seed from the config's ``seed``, execute the program id(s)."""
    files = [config_file] if isinstance(config_file, str) else list(config_file)
    config = load_config_files(files)
    pairs = dict(parse_override(p) for p in (overrides or []))
    for k, v in {**pairs, **kwargs}.items():
        config = merge_config(config, {k: v})

    parser = ConfigParser(config)
    seed = parser.get("seed")
    if seed is not None:
        parser.seed(seed)
    run_ids = [run_id] if isinstance(run_id, str) else list(run_id)
    for rid in run_ids:
        if rid in parser:
            parser.resolve(rid)
    return parser


def _normalize_cli_overrides(tokens: list[str]) -> list[str]:
    """Accept both override syntaxes: positional ``key=value`` and the
    reference CLI's ``--key value`` / ``--key=value`` pairs
    (``monai.bundle run`` forwards arbitrary ``--key value`` flags,
    reference docs/train.sh:115-119 — the bundles' docs/*.sh forward ``"$@"``
    the same way)."""
    out: list[str] = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.startswith("--"):
            key = tok[2:]
            if "=" in key:
                out.append(key)
            else:
                if i + 1 >= len(tokens) or tokens[i + 1].startswith("--"):
                    raise SystemExit(f"override flag --{key} is missing a value")
                out.append(f"{key}={tokens[i + 1]}")
                i += 1
        else:
            out.append(tok)
        i += 1
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: ``python -m factorizer_tpu_torch.bundle run --config_file F [overrides]``.

    Overrides use either positional ``key=value`` or the reference CLI's
    ``--key value`` / ``--key=value`` forms.  Parsed with a manual scan:
    argparse's positional/optional intermixing separates ``--key`` flags
    from their values, mispairing the overrides.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "run":
        raise SystemExit(
            "usage: factorizer_tpu_torch.bundle run --config_file FILE "
            "[--config_file OVERLAY ...] [--run_id ID ...] [key=value | --key value ...]"
        )
    config_files: list[str] = []
    run_ids: list[str] = []
    override_tokens: list[str] = []
    i = 1
    while i < len(argv):
        tok = argv[i]
        if tok in ("--config_file", "--run_id"):
            if i + 1 >= len(argv):
                raise SystemExit(f"{tok} is missing a value")
            (config_files if tok == "--config_file" else run_ids).append(argv[i + 1])
            i += 2
        elif tok.startswith("--config_file="):
            config_files.append(tok.split("=", 1)[1])
            i += 1
        elif tok.startswith("--run_id="):
            run_ids.append(tok.split("=", 1)[1])
            i += 1
        else:
            override_tokens.append(tok)
            i += 1
    if not config_files:
        raise SystemExit("at least one --config_file is required")
    overrides = _normalize_cli_overrides(override_tokens)
    joined = _join_torchrun_group()
    try:
        run(config_files, run_id=run_ids or ["initialize", "run"], overrides=overrides)
    finally:
        if joined:
            dist.destroy_process_group()


def _join_torchrun_group() -> bool:
    """Join the group that ``torchrun``'s environment describes (more than one process, on one node or several); False
    when there is none."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    from ..parallel.mesh import initialize_distributed

    initialize_distributed("env://")
    return True


if __name__ == "__main__":
    main()
