from .helpers import to_ntuple
from .weights import load_flax_variables

__all__ = ["to_ntuple", "load_flax_variables"]
