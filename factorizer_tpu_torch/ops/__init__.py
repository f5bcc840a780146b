from .math import norm2, relative_error
from .reshape import Matricize, Reshape, SWMatricize

__all__ = ["Matricize", "Reshape", "SWMatricize", "norm2", "relative_error"]
