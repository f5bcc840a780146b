from .deconv import Deconv, DeconvInit, batched_conv, sconv
from .inits import INIT_DISPATCH_MAP, NNDSVDInit, RandomInit, SVDInit, parse_init
from .kmeans import EntropyKMeans, FuzzyCMeans, KMeans
from .nmf import NMF, MatrixFactorization, translate_mf_kwargs
from .solvers import (
    SOLVER_DISPATCH_MAP,
    BCDSolver,
    Compose,
    CoordinateDescent,
    FastMultiplicativeUpdate,
    LeastSquares,
    MultiplicativeUpdate,
    ProjectedGradient,
    SemiMultiplicativeUpdate,
    WeightedMultiplicativeUpdate,
    parse_solver,
)
from .svd import SVD, infer_rank, randomized_svd

__all__ = [
    "Deconv",
    "DeconvInit",
    "batched_conv",
    "sconv",
    "RandomInit",
    "SVDInit",
    "NNDSVDInit",
    "INIT_DISPATCH_MAP",
    "parse_init",
    "KMeans",
    "FuzzyCMeans",
    "EntropyKMeans",
    "NMF",
    "MatrixFactorization",
    "translate_mf_kwargs",
    "BCDSolver",
    "LeastSquares",
    "ProjectedGradient",
    "CoordinateDescent",
    "MultiplicativeUpdate",
    "FastMultiplicativeUpdate",
    "WeightedMultiplicativeUpdate",
    "SemiMultiplicativeUpdate",
    "Compose",
    "SOLVER_DISPATCH_MAP",
    "parse_solver",
    "SVD",
    "infer_rank",
    "randomized_svd",
]
