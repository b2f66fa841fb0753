"""LEMURS's multi-detector data pipeline (port of
``vit4hep_tpu/data/lemurs/datasets.py``): lazy multi-file HDF5 with an LRU
cache of open handles, and transforms applied per batch.

A global ``(file, local index, class index)`` map spans every detector's
files; :class:`LEMURSCollator` one-hot encodes the detector label and runs
the transform pipeline on each batch; :class:`CollatedBatchIterator`
groups a batch's shuffled indices by file (a few contiguous HDF5 reads a
batch) and prepares the next batch on a background thread while the
device is busy. :class:`ArrayEvents` holds events in memory with the same
``read_indices``. h5py is imported where a file is opened.
:func:`enable_native_cache` switches either dataset's ``read_indices`` to
the mmap record cache (``data/native_cache.py``).
"""

from __future__ import annotations

import hashlib
import os
import queue
import threading
from collections import OrderedDict

import numpy as np

from vit4hep_tpu_torch.utils.logger import LOGGER

COND_KEYS = ("incident_energy", "incident_theta", "incident_phi")


def load_data(hdf5_file, local_index=None, dtype="float32"):
    """One event (or all) of an open file's structured ``events`` table."""
    slicer = local_index if local_index is not None else slice(None)
    event = hdf5_file["events"][slicer]
    data = {key: np.asarray(event[key], dtype) for key in (*COND_KEYS, "showers")}
    if local_index is not None and np.isscalar(local_index):
        data = {k: v[None] for k, v in data.items()}
    for key in COND_KEYS:
        if data[key].ndim == 1:
            data[key] = data[key][:, None]
    return data


def load_data_rows(hdf5_file, rows, dtype="float32"):
    """The events at increasing ``rows`` of an open file, E/theta/phi as
    (n, 1)."""
    event = hdf5_file["events"][rows]
    data = {key: np.asarray(event[key], dtype).reshape(len(rows), -1) for key in COND_KEYS}
    data["showers"] = np.asarray(event["showers"], dtype)
    return data


def read_first_file(files_dict, loader=load_data, dtype="float32"):
    """Every event of the first file of ``files_dict`` (the collators fit
    their file-backed transform state on it)."""
    import h5py  # host-side reader; the card's machine has none

    with h5py.File(next(iter(files_dict.values()))[0], "r") as f:
        return loader(f, local_index=None, dtype=dtype)


def _gather(parts, n):
    """Rows of ``parts`` ([(positions, block dict)]) placed at their
    positions in (n, ...) arrays."""
    first = parts[0][1]
    out = {k: np.empty((n, *v.shape[1:]), v.dtype) for k, v in first.items()}
    for pos, block in parts:
        for k, v in block.items():
            out[k][pos] = v
    return out


class LEMURSDataset:
    """Index map over {label: [files]} with an LRU cache of open handles."""

    def __init__(self, hdf5_files_dict, max_files_per_worker=4, dtype="float32"):
        self.max_open_files = int(max_files_per_worker)
        self.open_files_cache = OrderedDict()
        self.dtype = dtype
        self.label_to_idx = {label: i for i, label in enumerate(hdf5_files_dict.keys())}
        self.num_classes = len(self.label_to_idx)
        self.index_map = self._build_index_map(hdf5_files_dict)
        LOGGER.info(f"Dataset indexed with {len(self.index_map)} samples.")

    def _build_index_map(self, hdf5_files_dict):
        import h5py

        index_map = []
        for label, file_list in hdf5_files_dict.items():
            class_idx = self.label_to_idx[label]
            for file_path in file_list:
                try:
                    with h5py.File(file_path, "r") as f:
                        n = len(f["events"])
                    index_map.extend((file_path, local, class_idx) for local in range(n))
                except (OSError, KeyError) as e:
                    LOGGER.error(f"Could not read {file_path} for class {label}: {e}")
        return index_map

    def _get_file_handle(self, file_path):
        import h5py

        if file_path in self.open_files_cache:
            self.open_files_cache.move_to_end(file_path)
            return self.open_files_cache[file_path]
        if len(self.open_files_cache) >= self.max_open_files:
            _, old = self.open_files_cache.popitem(last=False)
            old.close()
        handle = h5py.File(file_path, "r")
        self.open_files_cache[file_path] = handle
        return handle

    def __len__(self):
        return len(self.index_map)

    def _read_rows(self, handle, rows):
        return load_data_rows(handle, rows, self.dtype)

    def read_indices(self, indices):
        """The events at global ``indices``, read file by file with the
        local rows sorted (h5py reads a few contiguous blocks); returns
        (data dict, class indices) in the requested order."""
        by_file: dict = {}
        classes = np.empty(len(indices), np.int32)
        for pos, idx in enumerate(indices):
            file_path, local, class_idx = self.index_map[idx]
            by_file.setdefault(file_path, []).append((local, pos))
            classes[pos] = class_idx
        parts = []
        for file_path, items in by_file.items():
            items.sort()
            rows = [local for local, _ in items]
            block = self._read_rows(self._get_file_handle(file_path), rows)
            parts.append((np.asarray([pos for _, pos in items]), block))
        return _gather(parts, len(indices)), classes


class ArrayEvents:
    """Events held in memory by label ({label: {field: (N, ...) array}}),
    with :class:`LEMURSDataset`'s ``read_indices``, ``num_classes`` and
    ``label_to_idx``: global indices run through the labels in order."""

    def __init__(self, events_by_label):
        self.label_to_idx = {label: i for i, label in enumerate(events_by_label)}
        self.num_classes = len(self.label_to_idx)
        fields = next(iter(events_by_label.values())).keys()
        self.fields = {k: np.concatenate([np.asarray(ev[k]) for ev in events_by_label.values()])
                       for k in fields}
        self.classes = np.concatenate([
            np.full(len(next(iter(ev.values()))), self.label_to_idx[label], np.int32)
            for label, ev in events_by_label.items()])

    def __len__(self):
        return len(self.classes)

    def read_indices(self, indices):
        idx = np.asarray(indices)
        return {k: v[idx] for k, v in self.fields.items()}, self.classes[idx]

    def spec(self) -> dict:
        """``{field: per-event shape}`` of the events."""
        return {k: tuple(v.shape[1:]) for k, v in self.fields.items()}


class LEMURSCollator:
    """The transform pipeline on each batch and the one-hot detector label
    (or the fixed ``gen_label``). The file-backed transform state is fitted
    at construction on ``warmup`` (a dict as :func:`load_data` returns),
    by default every event of the first training file."""

    def __init__(self, hdf5_train_dict, transforms, num_classes, gen_label=None,
                 return_us=False, rank=0, dtype="float32", warmup=None):
        self.transforms = transforms
        self.num_classes = int(num_classes)
        self.gen_label = gen_label
        self.return_us = bool(return_us)
        self.rank = rank
        if self.transforms:
            dummy = read_first_file(hdf5_train_dict, dtype=dtype) if warmup is None \
                else dict(warmup)
            for fn in self.transforms:
                dummy = fn(dummy, rank=self.rank)

    def __call__(self, batch_dict, class_indices):
        if self.gen_label is not None:
            labels = np.tile(np.asarray(self.gen_label, np.float32), (len(class_indices), 1))
        else:
            labels = np.eye(self.num_classes, dtype=np.float32)[class_indices]
        batch_dict = dict(batch_dict)
        batch_dict["label"] = labels
        for fn in self.transforms or ():
            batch_dict = fn(batch_dict)
        if self.return_us:
            energy_ratios = batch_dict.pop("extra_dims")
            conds = np.concatenate([batch_dict[k] for k in COND_KEYS], axis=-1)
            return np.asarray(energy_ratios, np.float32), np.asarray(conds, np.float32)
        shower = batch_dict.pop("showers")
        conds = np.concatenate([batch_dict["extra_dims"], *(batch_dict[k] for k in COND_KEYS),
                                batch_dict["label"]], axis=-1)
        return np.asarray(shower, np.float32), np.asarray(conds, np.float32)


class CollatedBatchIterator:
    """Shuffled epochs of collated batches, one batch prepared ahead on a
    background thread."""

    def __init__(self, dataset, collator, batch_size: int, seed=0, shuffle=True,
                 drop_last=True):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        n = len(dataset)
        self.batches_per_epoch = n // self.batch_size if drop_last else -(-n // self.batch_size)

    def _epoch_indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def _produce(self, out_q):
        # an exception must reach the consumer: a dead producer would leave
        # epoch_batches() waiting on the queue forever
        try:
            idx = self._epoch_indices()
            for start in range(0, self.batches_per_epoch * self.batch_size, self.batch_size):
                data, classes = self.dataset.read_indices(idx[start:start + self.batch_size])
                out_q.put(self.collator(data, classes))
            out_q.put(None)
        except BaseException as exc:  # noqa: BLE001 — raised again on the consumer's side
            out_q.put(exc)

    def epoch_batches(self):
        out_q: queue.Queue = queue.Queue(maxsize=2)
        threading.Thread(target=self._produce, args=(out_q,), daemon=True).start()
        while True:
            item = out_q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def __iter__(self):
        while True:
            yield from self.epoch_batches()

    def __next__(self):
        if not hasattr(self, "_iter"):
            self._iter = iter(self)
        return next(self._iter)


def _cache_name(dataset, spec) -> str:
    """``{type}_{records}_{sha1[:12]}.v4cache``: for a file-backed dataset the
    JAX package's fingerprint of its record set (file paths with their
    per-file counts, and the spec's fields), so that one cache directory
    serves both packages; for events in memory the labels with their
    counts, the fields and the events' bytes."""
    if isinstance(dataset, ArrayEvents):
        h = hashlib.sha1(repr((list(dataset.label_to_idx), np.bincount(
            dataset.classes, minlength=dataset.num_classes).tolist(),
            sorted(map(str, spec)))).encode())
        for k in sorted(spec):
            h.update(np.ascontiguousarray(dataset.fields[k], np.float32).tobytes())
        fingerprint, n = h.hexdigest()[:12], len(dataset)
    else:
        counts: dict = {}
        for file_path, _, _ in dataset.index_map:
            counts[file_path] = counts.get(file_path, 0) + 1
        fingerprint = hashlib.sha1(
            repr((sorted(counts.items()), sorted(map(str, spec)))).encode()).hexdigest()[:12]
        n = len(dataset.index_map)
    return f"{type(dataset).__name__}_{n}_{fingerprint}.v4cache"


def _event_blocks(dataset, spec):
    """The dataset's events as ``{field: (n, -1)}`` blocks in global index
    order: one block per file (read with h5py) or the events in memory."""
    if isinstance(dataset, ArrayEvents):
        yield {k: dataset.fields[k].reshape(len(dataset), -1) for k in spec}
        return
    import h5py  # host-side reader; the card's machine has none

    for file_path in dict.fromkeys(fp for fp, _, _ in dataset.index_map):
        with h5py.File(file_path, "r") as f:
            events = f["events"][:]
        yield {k: np.asarray(events[k], np.float32).reshape(len(events), -1) for k in spec}


def enable_native_cache(dataset, cache_dir, spec: dict):
    """Switch a lazy dataset's ``read_indices`` (:class:`LEMURSDataset`, its
    CaloHadronic subclass or :class:`ArrayEvents`) to the native mmap record
    cache. The cache is built once in ``cache_dir`` (from the HDF5 files in
    index-map order, or from the events in memory, so that global indices
    line up) and reused across runs; class indices stay host-side numpy."""
    from vit4hep_tpu_torch.data.native_cache import NativeRecordCache, build_cache

    os.makedirs(cache_dir, exist_ok=True)
    cache_path = os.path.join(str(cache_dir), _cache_name(dataset, spec))
    if isinstance(dataset, ArrayEvents):
        classes = dataset.classes
    else:
        classes = np.asarray([c for (_, _, c) in dataset.index_map], np.int32)
    if not os.path.exists(cache_path):
        # written aside and renamed: a crash mid-build leaves no half cache,
        # and two builders do not interleave
        tmp_path = f"{cache_path}.tmp.{os.getpid()}"
        build_cache(tmp_path, _event_blocks(dataset, spec), spec)
        os.replace(tmp_path, cache_path)
    cache = NativeRecordCache(cache_path, spec)
    if len(cache) != len(classes):
        raise ValueError(f"native cache has {len(cache)} records, the dataset {len(classes)}: "
                         f"delete {cache_path} to rebuild")

    def read_indices(indices):
        idx = np.asarray(indices)
        return cache.gather(idx), classes[idx]

    dataset.read_indices = read_indices
    dataset._native_cache = cache  # keeps the mapping open
    LOGGER.info(f"Using native record cache {cache_path}")
    return dataset
