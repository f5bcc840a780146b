from .reshape import Matricize, Reshape, SWMatricize

__all__ = ["Matricize", "Reshape", "SWMatricize"]
