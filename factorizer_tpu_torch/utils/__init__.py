from .helpers import resolve_device, to_ntuple
from .weights import load_flax_variables

__all__ = ["resolve_device", "to_ntuple", "load_flax_variables"]
