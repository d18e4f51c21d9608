"""libsvm parse and fixed-shape batches (port of the numpy paths of
armnet_tpu/data/libsvm.py).

Batch schema (unchanged): {'id' [B,F] int32, 'value' [B,F] f32, 'y' [B] f32,
'mask' [B] f32} as CPU tensors; the caller copies them to its device. The
final partial batch is padded to B with rows of id 0, value 1.0 and mask 0:
value 1.0, not 0.0, keeps a pad row in-distribution for the models that clamp
values into [1e-3, 1], and mask 0 keeps it out of every metric and of the
BatchNorm statistics.

A shuffled iterator permutes the rows with RandomState(seed + epoch) and
advances `epoch` each time an iteration starts, as the JAX iterator does, so
both packages visit the rows in the same order.

Not ported: the native C++ parser and the on-disk row cache (ROADMAP.md).
"""

import glob
import os
import warnings

import numpy as np
import torch

__all__ = ["parse_libsvm", "LibsvmDataset", "BatchIterator",
           "make_dataloaders"]


def _parse_numpy_fast(path, nfield):
    """Vectorized parse when every line has exactly `nfield` id:value pairs;
    None otherwise (the robust parser takes over)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data:
        return (np.zeros((0, nfield), np.int32),
                np.zeros((0, nfield), np.float32), np.zeros((0,), np.float32))
    flat = np.frombuffer(data.replace(b":", b" "), dtype=np.uint8)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # unmatched-trailing-data notice
            arr = np.fromstring(flat.tobytes().decode("ascii"), sep=" ")  # noqa: NPY201
    except ValueError:
        arr = np.array([])
    ncol = 1 + 2 * nfield
    if arr.size == 0 or arr.size % ncol != 0:
        return None
    # divisibility alone is not enough: lines whose missing/extra pairs
    # compensate would shift every row in between; a well-formed line has
    # exactly 2*nfield separator spaces after the ':' -> ' ' replacement
    sp = np.cumsum(flat == ord(" "))
    ends = np.flatnonzero(flat == ord("\n"))
    if flat.size and flat[-1] != ord("\n"):
        ends = np.append(ends, flat.size - 1)
    per_line = np.diff(np.concatenate([[0], sp[ends]]))
    if per_line.size != arr.size // ncol or not np.all(per_line == 2 * nfield):
        return None
    arr = arr.reshape(-1, ncol)
    return (arr[:, 1::2].astype(np.int32), arr[:, 2::2].astype(np.float32),
            arr[:, 0].astype(np.float32))


def _parse_numpy_robust(path, nfield):
    """Line-by-line parse skipping malformed lines with a message."""
    ids_rows, val_rows, labels = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                cols = line.split(" ")
                pairs = [c.split(":") for c in cols[1:]]
                row_ids = [int(p[0]) for p in pairs]
                row_vals = [float(p[1]) for p in pairs]
                if len(row_ids) != nfield:
                    raise ValueError("field count mismatch")
                labels.append(float(cols[0]))
            except (ValueError, IndexError):
                print(f'incorrect data format line "{line}" !')
                continue
            ids_rows.append(row_ids)
            val_rows.append(row_vals)
    return (np.asarray(ids_rows, np.int32).reshape(-1, nfield),
            np.asarray(val_rows, np.float32).reshape(-1, nfield),
            np.asarray(labels, np.float32))


def parse_libsvm(path, nfield):
    """(ids [N,F] int32, values [N,F] f32, labels [N] f32)."""
    out = _parse_numpy_fast(path, nfield)
    if out is None:
        out = _parse_numpy_robust(path, nfield)
    return out


class LibsvmDataset:
    """Parsed libsvm rows held in memory."""

    def __init__(self, path, nfield):
        self.ids, self.values, self.labels = parse_libsvm(path, nfield)
        self.nfield = nfield
        self.path = path

    def __len__(self):
        return self.labels.shape[0]


class BatchIterator:
    """Fixed-shape batches, in input order or shuffled per epoch."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0):
        self.ds = dataset
        self.bsz = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return (len(self.ds) + self.bsz - 1) // self.bsz

    def _order(self):
        n = len(self.ds)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def _batch(self, take):
        n, pad = take.shape[0], self.bsz - take.shape[0]
        ids = self.ds.ids[take]
        values = self.ds.values[take]
        y = self.ds.labels[take]
        mask = np.ones((self.bsz,), np.float32)
        if pad:
            ids = np.concatenate(
                [ids, np.zeros((pad, self.ds.nfield), np.int32)])
            values = np.concatenate(
                [values, np.ones((pad, self.ds.nfield), np.float32)])
            y = np.concatenate([y, np.zeros((pad,), np.float32)])
            mask[n:] = 0.0
        return {"id": torch.from_numpy(np.ascontiguousarray(ids)),
                "value": torch.from_numpy(np.ascontiguousarray(values)),
                "y": torch.from_numpy(np.ascontiguousarray(y)),
                "mask": torch.from_numpy(mask)}

    def __iter__(self):
        order = self._order()
        self.epoch += 1
        for b in range(len(self)):
            yield self._batch(order[b * self.bsz:(b + 1) * self.bsz])


def make_dataloaders(dataset, data_dir, nfield, batch_size, seed=0):
    """Iterators over {data_dir}/{dataset}/tr*|va*|te*libsvm: the train split
    shuffled, valid and test in input order."""
    base = os.path.join(data_dir, dataset)

    def pick(prefix):
        matches = sorted(glob.glob(os.path.join(base, f"{prefix}*libsvm")))
        if not matches:
            raise FileNotFoundError(
                f"no {prefix}*libsvm under {base} (expected the tr/va/te "
                f"naming convention)")
        return matches[0]

    train, val, test = (LibsvmDataset(pick(p), nfield)
                        for p in ("tr", "va", "te"))
    return (BatchIterator(train, batch_size, True, seed),
            BatchIterator(val, batch_size, False, seed),
            BatchIterator(test, batch_size, False, seed))
