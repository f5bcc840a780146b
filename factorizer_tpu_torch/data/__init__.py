"""Host-side data pipeline: NIfTI IO, datalists, datasets, the prefetching loader and the bundles' transforms.

numpy, scipy, ctypes and g++ only; batches stay numpy until the trainer moves
them to the card.  These modules are kept identical in code to the JAX
package's ``data`` package (only docstrings and comments differ), so one seed
gives the same batches, random transforms included, in both.
"""

from .nifti import NiftiImage, load_nifti, save_nifti
from .dataset import (
    Dataset,
    CacheDataset,
    PersistentDataset,
    DataLoader,
    load_decathlon_datalist,
    partition_datalist,
    stratified_kfold,
)
from . import transforms
