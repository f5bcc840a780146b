"""Alias module so that ``python -m factorizer_tpu_torch.bundle run ...`` works."""
from .config.bundle import main, run  # noqa: F401

if __name__ == "__main__":
    main()
