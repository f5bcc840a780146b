"""Datasets, datalists and the prefetching loader.

The workflow layer's replacement for MONAI ``Dataset``/``CacheDataset``/
torch ``DataLoader`` + ``DistributedSampler`` (reference:
model_zoo/factorizer_brats23/configs/train.yaml:173-200,
train_multigpu.yaml:8-13).  Loading/augmentation runs in a host thread pool
feeding a prefetch queue; per-process sharding replaces DistributedSampler
for multi-process training.
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

__all__ = [
    "Dataset",
    "CacheDataset",
    "DataLoader",
    "load_decathlon_datalist",
    "partition_datalist",
    "stratified_kfold",
]


def load_decathlon_datalist(
    path: str | Path,
    section: str = "training",
    fold: Optional[int] = None,
    base_dir: Optional[str | Path] = None,
) -> list[dict]:
    """Load a Decathlon-style datalist JSON and select a section / CV fold.

    With ``fold`` given: ``section='training'`` keeps items whose ``fold`` !=
    fold; ``'validation'`` keeps items whose ``fold`` == fold (reference:
    scripts/data.py:10-25).
    """
    with open(path) as f:
        data = json.load(f)
    items = data[section if section in data else "training"]

    if base_dir is not None:
        base = Path(base_dir)

        _exts = (".nii", ".nii.gz", ".png", ".jpg", ".jpeg", ".bmp")

        def fix(v):
            if isinstance(v, str) and v.lower().endswith(_exts):
                return str(base / v)
            if isinstance(v, list):
                return [fix(x) for x in v]
            return v

        items = [{k: fix(v) for k, v in it.items()} for it in items]

    if fold is not None:
        if section in ("training", "train"):
            items = [x for x in items if x.get("fold") != fold]
        elif section in ("validation", "val"):
            items = [x for x in items if x.get("fold") == fold]
    return items


def stratified_kfold(
    values: Sequence[float], num_folds: int = 5, num_bins: int = 5, seed: int = 42
) -> list[int]:
    """Fold assignment stratified by quantized ``values`` (lesion volumes).

    Reimplements the reference's StratifiedKFold-over-histogram-bins scheme
    (reference: scripts/make_datalist.py:87-108) without sklearn: bin the
    values, then deal each bin's shuffled members round-robin into folds.
    """
    values = np.asarray(values, dtype=np.float64)
    edges = np.histogram_bin_edges(values, bins=num_bins)
    bins = np.digitize(values, edges[:-1])
    rng = np.random.default_rng(seed)

    folds = np.zeros(len(values), dtype=np.int64)
    for b in np.unique(bins):
        idx = np.nonzero(bins == b)[0]
        rng.shuffle(idx)
        for j, i in enumerate(idx):
            folds[i] = j % num_folds
    return folds.tolist()


def partition_datalist(items: Sequence[Any], num_partitions: int, index: int) -> list[Any]:
    """Contiguous-stride shard of a datalist (DistributedSampler analogue)."""
    return [x for j, x in enumerate(items) if j % num_partitions == index]


class Dataset:
    """Applies a transform lazily per item."""

    def __init__(self, data: Sequence[dict], transform: Optional[Callable] = None) -> None:
        self.data = list(data)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> dict:
        item = dict(self.data[idx])
        if self.transform is not None:
            item = self.transform(item)
        return item


class CacheDataset(Dataset):
    """Caches the deterministic transform output; applies the random tail lazily.

    The MONAI CacheDataset analogue: pass the deterministic pipeline as
    ``transform`` and the augmentation pipeline as ``random_transform``.
    """

    def __init__(
        self,
        data: Sequence[dict],
        transform: Optional[Callable] = None,
        random_transform: Optional[Callable] = None,
        num_workers: int = 4,
        progress: bool = False,
    ) -> None:
        super().__init__(data, transform)
        self.random_transform = random_transform
        self._cache: list[Optional[dict]] = [None] * len(self.data)
        self._lock = threading.Lock()
        if num_workers > 0 and transform is not None:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_workers) as pool:
                for i, item in enumerate(pool.map(self._load, range(len(self.data)))):
                    self._cache[i] = item

    def _load(self, idx: int) -> dict:
        item = dict(self.data[idx])
        if self.transform is not None:
            item = self.transform(item)
        return item

    def __getitem__(self, idx: int) -> dict:
        item = self._cache[idx]
        if item is None:
            item = self._load(idx)
            with self._lock:
                self._cache[idx] = item
        if self.random_transform is not None:
            item = self.random_transform(dict(item))
        return item


class PersistentDataset(Dataset):
    """Disk-cached deterministic transforms; random tail applied lazily.

    The MONAI ``PersistentDataset`` analogue: the first access of each case
    writes the deterministic-transform output to ``cache_dir`` (atomic
    pickle), and every later access — across epochs, worker processes, AND
    separate runs — reads it back instead of re-running load/orient/spacing/
    normalize.  Cache keys hash the case dict only, so clear ``cache_dir``
    (or pass a new ``cache_tag``) when the deterministic pipeline changes.
    """

    def __init__(
        self,
        data: Sequence[dict],
        transform: Optional[Callable] = None,
        random_transform: Optional[Callable] = None,
        cache_dir: str | Path = "persistent_cache",
        cache_tag: str = "",
    ) -> None:
        super().__init__(data, transform)
        self.random_transform = random_transform
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.cache_tag = cache_tag

    @staticmethod
    def _stable(v) -> str:
        """Content-complete string for hashing: str(ndarray) truncates large
        arrays with '...', which would collide distinct cases."""
        import hashlib

        if isinstance(v, np.ndarray):
            return (
                f"ndarray:{v.shape}:{v.dtype}:"
                + hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            )
        if isinstance(v, (bytes, bytearray)):
            return "bytes:" + hashlib.sha1(bytes(v)).hexdigest()
        return f"{type(v).__name__}:{v}"

    def _key(self, idx: int) -> Path:
        import hashlib
        import json as _json

        case = self.data[idx]
        blob = _json.dumps(
            {k: self._stable(v) for k, v in sorted(case.items())}, sort_keys=True
        ) + self.cache_tag
        return self.cache_dir / (hashlib.sha1(blob.encode()).hexdigest() + ".pkl")

    def __getitem__(self, idx: int) -> dict:
        import pickle

        path = self._key(idx)
        item = None
        if path.exists():
            try:
                item = pickle.loads(path.read_bytes())
            except Exception:
                item = None  # corrupt/partial entry: recompute below
        if item is None:
            item = dict(self.data[idx])
            if self.transform is not None:
                item = self.transform(item)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_bytes(pickle.dumps(item, protocol=4))
            os.replace(tmp, path)  # atomic: safe under concurrent workers
        if self.random_transform is not None:
            item = self.random_transform(dict(item))
        return item


def _default_collate(items: list[dict]) -> dict:
    """Stack array-valued keys into batches; pass lists through otherwise.

    List-valued items (a transform emitting multiple samples per case, e.g.
    ``RandCropByPosNegLabeld(num_samples>1)``) are flattened into the batch,
    matching MONAI's ``list_data_collate``.
    """
    flat: list[dict] = []
    for it in items:
        flat.extend(it) if isinstance(it, list) else flat.append(it)
    out: dict = {}
    for k in flat[0]:
        vals = [it[k] for it in flat]
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals, axis=0)
        else:
            out[k] = vals
    return out


# ---- process-pool worker plumbing ------------------------------------------
# Forked workers inherit the dataset via this module global (set just before
# the fork), so neither the dataset nor its transform chain is ever pickled;
# only indices go in and transformed arrays come back.  A registry keyed by
# a per-pool token (rather than one module global) lets several loaders run
# concurrently: each pool's workers resolve their own dataset from the copy
# of the registry they inherited at fork time.
_shared_datasets: dict[int, "Dataset"] = {}
_pool_tokens = itertools.count()
_worker_dataset: Optional["Dataset"] = None
_worker_id: Optional[int] = None
_worker_epoch: int = 0


def get_worker_id() -> Optional[int]:
    """The loader worker id in a forked pool worker; None on the main process.

    Used by ``RandomizableTransform.rng``: fork copies the parent's
    ``SeedSequence`` spawn counters into every worker, so without a distinct
    per-worker key all workers would draw identical augmentation streams.
    """
    return _worker_id


def get_worker_epoch() -> int:
    """The loader epoch the current worker is producing for.

    Folded into the per-worker RNG spawn key: workers get the same ids every
    epoch, so without the epoch every epoch would replay epoch 1's
    augmentation stream exactly.  Under ``persistent_workers`` the epoch is
    a shared Value updated by ``set_epoch`` (the pool outlives epochs);
    otherwise it is the int the per-epoch pool was forked with.
    """
    e = _worker_epoch
    return int(e.value) if hasattr(e, "value") else int(e)


def _pool_initializer(counter, token: int, epoch) -> None:
    global _worker_id, _worker_dataset, _worker_epoch
    with counter.get_lock():
        _worker_id = int(counter.value)
        counter.value += 1
    _worker_dataset = _shared_datasets[token]
    _worker_epoch = epoch


def _getitem_shared(idx: int):
    return _worker_dataset[idx]


class _ProducerError:
    """Queue sentinel carrying a producer-thread exception to the consumer."""

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


class DataLoader:
    """Prefetching loader with thread- or process-pool workers.

    Serves the role of torch's process-based loader (reference:
    train.yaml:190 ``num_workers: 8``): overlap host-side IO/augmentation
    with device compute.  Each epoch reshuffles with a per-epoch seed for
    reproducibility.

    ``use_processes=True`` runs the per-item work in forked worker
    processes (ProcessPoolExecutor) instead of threads — numpy/scipy
    augmentation only partly releases the GIL, so CPU-bound transform
    chains (e.g. ``RandAffined`` on 4x128^3 volumes) need processes to
    scale past ~1 core; time the loader to check.  Workers
    inherit the dataset by fork; only indices and the transformed arrays
    cross the process boundary.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        collate_fn: Callable = _default_collate,
        seed: int = 0,
        prefetch: int = 2,
        use_processes: bool = False,
        persistent_workers: bool = False,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 0)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self.seed = seed
        self.prefetch = prefetch
        self.use_processes = use_processes
        # Fork the process pool ONCE and reuse it across epochs (torch's
        # persistent_workers): a per-epoch fork re-pays page-table copy of
        # the whole parent (framework runtime + cached datasets) every epoch.
        # Workers read the epoch from a shared Value, so per-worker
        # augmentation streams still advance per epoch.  Only safe when the
        # dataset is fully constructed before iteration (CacheDataset warms
        # in its ctor; PersistentDataset shares its cache on disk) — a cache
        # filled lazily in the parent after the fork would be invisible to
        # the workers.
        self.persistent_workers = bool(persistent_workers and use_processes)
        self._pool = None
        self._pool_token: Optional[int] = None
        self._epoch_value = None
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> list[list[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        batches = [
            idx[i : i + self.batch_size].tolist()
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._batches()
        if self.num_workers == 0:
            for b in batches:
                yield self.collate_fn([self.dataset[i] for i in b])
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        token = next(_pool_tokens)

        def make_proc_pool(token_, epoch):
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            # registry entry must exist before the (lazy) fork; each
            # pool resolves its own entry, so concurrent loaders can't
            # hand each other's dataset to their workers
            _shared_datasets[token_] = self.dataset
            ctx = mp.get_context("fork")
            counter = ctx.Value("i", 0)
            return ProcessPoolExecutor(
                self.num_workers,
                mp_context=ctx,
                initializer=_pool_initializer,
                initargs=(counter, token_, epoch),
            )

        def make_pool():
            """Returns (pool, owned): ``owned`` pools are closed per epoch."""
            if self.use_processes:
                if self.persistent_workers:
                    if self._pool is None:
                        import multiprocessing as mp

                        self._pool_token = token
                        self._epoch_value = mp.get_context("fork").Value(
                            "i", self.epoch
                        )
                        self._pool = make_proc_pool(token, self._epoch_value)
                    with self._epoch_value.get_lock():
                        self._epoch_value.value = self.epoch
                    return self._pool, False
                return make_proc_pool(token, self.epoch), True
            from concurrent.futures import ThreadPoolExecutor

            return ThreadPoolExecutor(self.num_workers), True

        def put(item) -> bool:
            """stop-aware q.put: an abandoned consumer (early break) sets
            ``stop`` but never drains the queue; a plain blocking put would
            wedge the producer here forever, leaking the worker pool."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pool, owned = make_pool()
                try:
                    if self.use_processes:
                        # keep a bounded window of in-flight items so parallelism
                        # spans batch boundaries without unbounded memory
                        window = self.num_workers + self.batch_size
                        flat = [i for b in batches for i in b]
                        futs: dict[int, Any] = {}
                        submitted = taken = 0
                        for b in batches:
                            if stop.is_set():
                                return
                            while submitted < len(flat) and submitted - taken < window:
                                futs[submitted] = pool.submit(_getitem_shared, flat[submitted])
                                submitted += 1
                            items = []
                            for _ in b:
                                items.append(futs.pop(taken).result())
                                taken += 1
                                if submitted < len(flat):
                                    futs[submitted] = pool.submit(
                                        _getitem_shared, flat[submitted]
                                    )
                                    submitted += 1
                            if not put(self.collate_fn(items)):
                                return
                    else:
                        for b in batches:
                            if stop.is_set():
                                return
                            items = list(pool.map(self.dataset.__getitem__, b))
                            if not put(self.collate_fn(items)):
                                return
                finally:
                    if owned:
                        pool.shutdown()
                put(None)
            except BaseException as exc:  # surface worker/transform errors
                # without a sentinel the consumer would block on q.get()
                # forever while this daemon thread dies silently
                put(_ProducerError(exc))
            finally:
                if not self.persistent_workers:
                    _shared_datasets.pop(token, None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, _ProducerError):
                    raise RuntimeError("DataLoader worker failed") from batch.exc
                yield batch
        finally:
            stop.set()

    def close(self) -> None:
        """Shut down a persistent worker pool (no-op otherwise)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
            if self._pool_token is not None:
                _shared_datasets.pop(self._pool_token, None)
                self._pool_token = None

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
