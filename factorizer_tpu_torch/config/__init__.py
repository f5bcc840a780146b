"""The bundles' YAML config system and its CLI runner (``python -m factorizer_tpu_torch.bundle run``)."""

from .bundle import run
from .parser import ConfigParser, load_config_files, merge_config, parse_override

__all__ = ["ConfigParser", "load_config_files", "merge_config", "parse_override", "run"]
