from .helpers import as_tuple, materialize, partialize, resolve_device, to_ntuple
from .weights import load_flax_variables

__all__ = ["as_tuple", "materialize", "partialize", "resolve_device", "to_ntuple", "load_flax_variables"]
