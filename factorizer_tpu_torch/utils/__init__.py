from .helpers import as_tuple, has_args, is_partializable, materialize, partialize, resolve_device, spec_accepts, to_ntuple
from .weights import load_flax_variables

__all__ = [
    "as_tuple", "has_args", "is_partializable", "materialize", "partialize", "resolve_device", "spec_accepts", "to_ntuple",
    "load_flax_variables",
]
