"""UCI numeric-dataset path, multi-class (copy of armnet_tpu/data/uci.py).

Each numeric row becomes a record of the libsvm batch schema with id =
column index for every field. Features are standardized with a scaler fit
on the training split. The train/test split comes from the UCI-121
`conxuntos.dat` index file beside `{name}.arff`, else from
`{name}_train.arff` and `{name}_test.arff`, and an optional validation
split is carved from train. Rows feed the port's BatchIterator
(data/libsvm.py), so the multi-class path shares the trainer, the steps
and the checkpoints of the libsvm path; `nclass` rides on every loader.
"""

import os
import warnings

import numpy as np

from armnet_tpu_torch.data.libsvm import BatchIterator

__all__ = ["load_arff", "load_uci_dataset", "UCIDataset", "uci_loader",
           "Standardizer"]


def load_arff(path):
    """Minimal ARFF reader for the UCI-121 layout: all-numeric attributes
    plus one final nominal class attribute.

    Returns (X [N, D] f32, y [N] int32 class indices, nclass).
    """
    attr_names, nominal_values = [], None
    data_lines = []
    in_data = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("%"):
                continue
            low = line.lower()
            if in_data:
                data_lines.append(line)
            elif low.startswith("@attribute"):
                # "@attribute name numeric" or "@attribute clase {0,1,...}"
                rest = line.split(None, 1)[1].strip()
                if "{" in rest:
                    name = rest[:rest.index("{")].strip().strip("'\"")
                    vals = rest[rest.index("{") + 1:rest.rindex("}")]
                    nominal_values = [v.strip().strip("'\"")
                                      for v in vals.split(",")]
                    attr_names.append(name)
                else:
                    attr_names.append(rest.split()[0].strip("'\""))
            elif low.startswith("@data"):
                in_data = True
    if nominal_values is None:
        raise ValueError(f"{path}: expected a nominal class attribute "
                         "(UCI-121 layout: numeric features + nominal class)")
    cls_index = {v: i for i, v in enumerate(nominal_values)}
    ncol = len(attr_names)
    X = np.empty((len(data_lines), ncol - 1), np.float32)
    y = np.empty((len(data_lines),), np.int32)
    for i, line in enumerate(data_lines):
        cols = line.split(",")
        if len(cols) != ncol:
            raise ValueError(f"{path}: row {i} has {len(cols)} columns, "
                             f"expected {ncol}")
        X[i] = [float(c) for c in cols[:-1]]
        label = cols[-1].strip().strip("'\"")
        y[i] = cls_index[label] if label in cls_index else int(float(label))
    return X, y, len(nominal_values)


def load_uci_dataset(folder, train=True):
    """One UCI dataset folder -> (X, y, nclass) of its train or test split:
    `{name}.arff` split by the two index lines of `conxuntos.dat` where it
    exists, else `{name}_train.arff` / `{name}_test.arff`."""
    name = os.path.basename(os.path.normpath(folder))
    full = os.path.join(folder, f"{name}.arff")
    if os.path.exists(full):
        X, y, nclass = load_arff(full)
        with open(os.path.join(folder, "conxuntos.dat")) as f:
            lines = f.readlines()
        train_idx = np.array([int(e) for e in lines[0].split()], np.int64)
        test_idx = np.array([int(e) for e in lines[1].split()], np.int64)
        if set(train_idx.tolist()) & set(test_idx.tolist()):
            raise ValueError(f"{folder}/conxuntos.dat: the train and test "
                             f"index lines overlap")
        idx = train_idx if train else test_idx
        return X[idx], y[idx], nclass
    part = "train" if train else "test"
    return load_arff(os.path.join(folder, f"{name}_{part}.arff"))


class Standardizer:
    """Per-column (x - mean) / std fit on train (StandardScaler parity:
    population std, zero-variance columns left unscaled)."""

    def __init__(self, X):
        self.mean = X.mean(axis=0)
        std = X.std(axis=0)
        self.std = np.where(std == 0.0, 1.0, std)

    def __call__(self, X):
        return ((X - self.mean) / self.std).astype(np.float32)


class UCIDataset:
    """Numeric rows in the libsvm batch schema: id = column index per field.
    The id matrix is a zero-copy broadcast view of arange(nfield)."""

    def __init__(self, X, y):
        n, nfield = X.shape
        self.ids = np.broadcast_to(np.arange(nfield, dtype=np.int32),
                                   (n, nfield))
        self.values = np.ascontiguousarray(X, np.float32)
        self.labels = np.asarray(y, np.float32)
        self.nfield = nfield

    def __len__(self):
        return self.labels.shape[0]


def uci_loader(data_dir, batch_size, valid_perc=0.0, seed=0, device=None):
    """(train, valid, test) BatchIterators for a UCI folder, each carrying
    `nclass`.

    valid_perc > 0 carves a validation split from train, shuffled with
    RandomState(0) whatever the run's seed; at valid_perc == 0 the valid
    loader aliases the train split (with a warning), so early stopping
    then selects on training accuracy. The scaler is fit on train only and
    applied to every split; the train iterator shuffles per epoch. The
    iterators hand over tensors on `device`.
    """
    Xtr, ytr, nclass = load_uci_dataset(data_dir, train=True)
    if valid_perc > 0.0:
        order = np.random.RandomState(0).permutation(Xtr.shape[0])
        ncut = int(round(Xtr.shape[0] * valid_perc))
        val_idx, tr_idx = order[:ncut], order[ncut:]
        Xva, yva = Xtr[val_idx], ytr[val_idx]
        Xtr, ytr = Xtr[tr_idx], ytr[tr_idx]
    else:
        Xva, yva = None, None

    scaler = Standardizer(Xtr)
    train = BatchIterator(UCIDataset(scaler(Xtr), ytr), batch_size, True, seed,
                          device)
    if Xva is not None:
        valid = BatchIterator(UCIDataset(scaler(Xva), yva), batch_size, False,
                              seed, device)
    else:
        warnings.warn(
            "valid_perc=0: the validation loader aliases the TRAIN split; "
            "early stopping will select on training accuracy; pass "
            "--valid_perc to carve a real validation split", stacklevel=2)
        valid = BatchIterator(train.ds, batch_size, False, seed, device)
    Xte, yte, _ = load_uci_dataset(data_dir, train=False)
    test = BatchIterator(UCIDataset(scaler(Xte), yte), batch_size, False, seed,
                         device)

    train.nclass = valid.nclass = test.nclass = nclass
    return train, valid, test
