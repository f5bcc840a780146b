from .deconv import Deconv, DeconvInit, batched_conv, sconv
from .inits import RandomInit
from .nmf import NMF, MatrixFactorization, infer_rank
from .solvers import CoordinateDescent, MultiplicativeUpdate, SOLVER_DISPATCH_MAP

__all__ = [
    "Deconv",
    "DeconvInit",
    "batched_conv",
    "sconv",
    "RandomInit",
    "NMF",
    "MatrixFactorization",
    "infer_rank",
    "CoordinateDescent",
    "MultiplicativeUpdate",
    "SOLVER_DISPATCH_MAP",
]
