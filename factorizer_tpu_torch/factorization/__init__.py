from .inits import RandomInit
from .nmf import NMF, MatrixFactorization, infer_rank
from .solvers import CoordinateDescent, MultiplicativeUpdate, SOLVER_DISPATCH_MAP

__all__ = [
    "RandomInit",
    "NMF",
    "MatrixFactorization",
    "infer_rank",
    "CoordinateDescent",
    "MultiplicativeUpdate",
    "SOLVER_DISPATCH_MAP",
]
