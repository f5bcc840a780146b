from . import debug, profiling
from .debug import assert_finite, debug_nans, tree_norms
from .helpers import (
    Universaltuple, as_tuple, cumprod, has_args, is_partializable, materialize, partialize, resolve_device, spec_accepts,
    to_ntuple,
)
from .weights import load_flax_variables

__all__ = [
    "Universaltuple", "as_tuple", "cumprod", "has_args", "is_partializable", "materialize", "partialize",
    "resolve_device", "spec_accepts", "to_ntuple", "load_flax_variables", "debug", "profiling", "debug_nans",
    "assert_finite", "tree_norms",
]
