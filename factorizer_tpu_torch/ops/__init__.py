from .math import dot, kl_divergence, norm2, relative_error, softmax
from .reshape import Matricize, Reshape, SWMatricize

__all__ = ["Matricize", "Reshape", "SWMatricize", "dot", "kl_divergence", "norm2", "relative_error", "softmax"]
