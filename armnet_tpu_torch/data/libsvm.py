"""libsvm parse, row cache and fixed-shape batches (port of
armnet_tpu/data/libsvm.py).

Parse chain (parse_libsvm): the row cache, then the native parser
(data/native.py, the port's own build of data/csrc/libsvm_parser.cc),
then a vectorized numpy parse, then a line-by-line one. Every route skips
malformed lines and warns with their count (the line-by-line parse also
prints each, as the reference does); a native failure warns and falls
back. LibsvmDataset records the route (`route`: 'cache', 'native',
'numpy_fast' or 'numpy_robust') and the seconds it took, which the trainer
and predict log.

Row cache: three .npy files (ids, values, labels) under ARMNET_CACHE_DIR
(default `.cache/` at the repository root; the JAX package reads the same
variable and writes the same arrays under the same keys), keyed by the
file's absolute path, size, mtime, nfield and byte range; loaded through
mmap past 512 MB; published through a pid-suffixed temporary file and
os.replace, so a concurrent run never loads a half-written file; a
truncated or corrupt cache warns and is re-parsed.

Byte-range shards: shard_byte_range(path, i, P) splits the file's bytes
evenly, and a row belongs to the shard holding its first byte, on every
route (the native parser's shard_range), so disjoint ranges partition the
rows exactly.

Batch schema (unchanged): {'id' [B,F] int32, 'value' [B,F] f32, 'y' [B]
f32, 'mask' [B] f32}. The final partial batch is padded to B with rows of
id 0, value 1.0 and mask 0: value 1.0, not 0.0, keeps a pad row
in-distribution for the models that clamp values into [1e-3, 1], and mask
0 keeps it out of every metric and of the BatchNorm statistics.

Epoch order: a shuffled iterator permutes the rows with RandomState(seed +
epoch).permutation(n) and advances `epoch` each time an iteration starts,
as the JAX iterator does. The order is drawn by the native port of that
permutation (data/native.py; numpy, warned, where it cannot be built):
when a shuffled epoch starts, a worker thread draws the next epoch's
order with the GIL released, and the next epoch takes it if its (seed,
epoch, rows) still match, else draws its own at its start (the trainer
resets `seed` and `epoch` after construction). `orders_ahead` and
`orders_at_start` count the two.

BatchIterator(device=...) hands over tensors on the device, by one of two
paths, chosen at the first iteration (`resident` says which):

  * resident: on a CUDA device whose free memory holds the rows within
    RESIDENT_SHARE of it, the ids, values, labels and a mask column go to
    the card once, with one pad row appended (a broadcast id view, as the
    UCI sets have, goes as its one row and a zero row). Each epoch's order
    goes to the card once, from pinned memory on a copy stream, its tail
    past the rows pointing at the pad row, and the consuming stream waits
    on the copy's event; each batch is index_select of the resident
    columns at its slice of the order, on the consumer's stream: no host
    gather, pinning or copy a batch.
  * streaming (any other device, or rows that do not fit): the batch's
    rows are gathered on the host. On a CUDA device one batch is kept in
    flight: while the caller runs step k, batch k+1 is already copied from
    pinned host memory with non_blocking on a copy stream of its own; the
    consuming stream waits on the copy's event before the batch is handed
    over, the device tensors are recorded on that stream, and the pinned
    source is kept until its copy has completed. ARMNET_PREFETCH_THREAD=1
    moves the host batch assembly and the copy into a worker thread (queue
    depth 2; off by default, as in the JAX package; never in a
    multi-process run).

Both paths give the same batches, bit for bit.

Multi-process runs (make_dataloaders(shard=(index, size), group=...)):
each process of the data group parses only its byte-range shard; the
global row count is the shard counts summed over the group (one
all-reduce), so every process derives the same number of global batches;
each batch holds this process's batch_size / size rows of the global
batch, drawn from its local shard (mask-0 padding where the shard runs
out first).
"""

import glob
import hashlib
import operator
import os
import queue
import threading
import time
import warnings

import numpy as np
import torch

from armnet_tpu_torch.data import native
from armnet_tpu_torch.parallel.mesh import all_reduce_values, multi_process
from armnet_tpu_torch.utils.tracing import span

__all__ = ["parse_libsvm", "parse_routed", "shard_byte_range", "cache_dir",
           "LibsvmDataset", "BatchIterator", "make_dataloaders", "draw_order",
           "resident_bytes", "resident_fits", "RESIDENT_SHARE"]

MMAP_BYTES = 512 * 1024 * 1024
# the rows go to the card where they take at most this share of its free
# memory at the first iteration
RESIDENT_SHARE = 0.25


def cache_dir():
    """The row cache's directory: ARMNET_CACHE_DIR, else .cache/ at the
    repository root."""
    return os.environ.get("ARMNET_CACHE_DIR", os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".cache"))


def _cache_key(path, nfield, byte_range=None):
    st = os.stat(path)
    rng = f":{byte_range[0]}-{byte_range[1]}" if byte_range else ""
    raw = (f"{os.path.abspath(path)}:{st.st_size}:{int(st.st_mtime)}"
           f":{nfield}:v1{rng}")
    return hashlib.sha1(raw.encode()).hexdigest()[:16]


def _shard_bytes(path, lo, hi):
    """The bytes of the rows whose first byte lies in [lo, hi): shard 0
    starts at 0, the others at the first line start >= lo, and the last
    row may run past hi to its newline (the native shard_range)."""
    size = os.path.getsize(path)
    lo, hi = max(lo, 0), min(hi, size)
    with open(path, "rb") as f:
        if lo > 0:
            f.seek(lo - 1)
            # if byte lo - 1 is '\n', the line starting AT lo is ours
            if f.read(1) != b"\n":
                while True:
                    c = f.read(1 << 16)
                    if not c:
                        return b""
                    nl = c.find(b"\n")
                    if nl >= 0:
                        f.seek(f.tell() - len(c) + nl + 1)
                        break
        start = f.tell()
        if start >= hi:
            return b""
        data = f.read(hi - start)
        if data and not data.endswith(b"\n"):
            while True:
                c = f.read(1 << 16)
                if not c:
                    break
                nl = c.find(b"\n")
                if nl >= 0:
                    data += c[:nl + 1]
                    break
                data += c
    return data


def shard_byte_range(path, shard_idx, num_shards):
    """[lo, hi) of the even byte-range split of a file."""
    size = os.path.getsize(path)
    return (shard_idx * size // num_shards,
            (shard_idx + 1) * size // num_shards)


def _read(path, byte_range):
    if byte_range is not None:
        return _shard_bytes(path, *byte_range)
    with open(path, "rb") as f:
        return f.read()


def _empty(nfield):
    return (np.zeros((0, nfield), np.int32),
            np.zeros((0, nfield), np.float32), np.zeros((0,), np.float32))


def _parse_native(path, nfield, byte_range=None):
    """The native parser; None (with a warning) where it fails."""
    try:
        if byte_range is not None:
            return native.parse_file_range(path, nfield, *byte_range)
        return native.parse_file(path, nfield)
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native libsvm parser failed ({e}); using the numpy "
                      f"parser")
        return None


def _parse_numpy_fast(path, nfield, byte_range=None):
    """Vectorized parse when every line has exactly `nfield` id:value pairs;
    None otherwise (the robust parser takes over)."""
    data = _read(path, byte_range)
    if not data:
        return _empty(nfield)
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


def _parse_numpy_robust(path, nfield, byte_range=None):
    """Line-by-line parse skipping malformed lines: each is printed, as the
    reference prints it, and their count is warned."""
    ids_rows, val_rows, labels = [], [], []
    bad = 0
    for line in _read(path, byte_range).decode(errors="replace").splitlines():
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
            label = float(cols[0])
        except (ValueError, IndexError):
            print(f'incorrect data format line "{line}" !')
            bad += 1
            continue
        labels.append(label)
        ids_rows.append(row_ids)
        val_rows.append(row_vals)
    if bad:
        warnings.warn(f"{path}: skipped {bad} malformed line(s)")
    return (np.asarray(ids_rows, np.int32).reshape(-1, nfield),
            np.asarray(val_rows, np.float32).reshape(-1, nfield),
            np.asarray(labels, np.float32))


def _cache_names(path, nfield, byte_range):
    base = os.path.join(cache_dir(),
                        f"libsvm_{_cache_key(path, nfield, byte_range)}")
    return [f"{base}.{k}.npy" for k in ("ids", "values", "labels")]


def _load_cache(names, nfield):
    if not all(os.path.exists(n) for n in names):
        return None
    mode = "r" if sum(os.path.getsize(n) for n in names) > MMAP_BYTES else None
    try:
        out = tuple(np.load(n, mmap_mode=mode) for n in names)
    except (OSError, ValueError, EOFError) as e:
        warnings.warn(f"libsvm cache unreadable ({e}); re-parsing")
        return None
    ids, values, labels = out
    n = labels.shape[0] if labels.ndim == 1 else -1
    if (ids.shape != (n, nfield) or values.shape != (n, nfield)
            or ids.dtype != np.int32 or values.dtype != np.float32
            or labels.dtype != np.float32):
        warnings.warn(f"libsvm cache inconsistent (ids {ids.shape}, values "
                      f"{values.shape}, labels {labels.shape}); re-parsing")
        return None
    return out


def _publish_cache(names, arrays):
    """Atomic publish: a pid-suffixed temporary file, then os.replace."""
    tmp = None
    try:
        os.makedirs(os.path.dirname(names[0]), exist_ok=True)
        for name, arr in zip(names, arrays):
            tmp = f"{name}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, arr)
            os.replace(tmp, name)
    except OSError as e:
        warnings.warn(f"libsvm cache not written ({e})")
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)


def parse_routed(path, nfield, use_cache=True, byte_range=None):
    """((ids [N,F] int32, values [N,F] f32, labels [N] f32), route)."""
    names = _cache_names(path, nfield, byte_range) if use_cache else None
    if names is not None:
        out = _load_cache(names, nfield)
        if out is not None:
            return out, "cache"
    for route, parse in (("native", _parse_native),
                         ("numpy_fast", _parse_numpy_fast),
                         ("numpy_robust", _parse_numpy_robust)):
        out = parse(path, nfield, byte_range)
        if out is not None:
            break
    if names is not None:
        _publish_cache(names, out)
    return out, route


def parse_libsvm(path, nfield, use_cache=True, byte_range=None):
    """(ids [N,F] int32, values [N,F] f32, labels [N] f32) of a libsvm file,
    or of the rows whose first byte lies in byte_range=(lo, hi)."""
    return parse_routed(path, nfield, use_cache, byte_range)[0]


class LibsvmDataset:
    """Parsed libsvm rows held in memory (or mmapped from the cache).

    shard=(i, P): only the i-th of P byte-range shards. `route` and
    `parse_seconds` say how the rows were read."""

    def __init__(self, path, nfield, use_cache=True, shard=None):
        byte_range = shard_byte_range(path, *shard) if shard else None
        t0 = time.perf_counter()
        (self.ids, self.values, self.labels), self.route = parse_routed(
            path, nfield, use_cache, byte_range)
        self.parse_seconds = time.perf_counter() - t0
        self.nfield = nfield
        self.path = path
        self.shard = shard

    def __len__(self):
        return self.labels.shape[0]


def _process_local_rows(global_batch, index, size):
    """[lo, hi) rows of the global batch that process `index` of `size`
    contributes."""
    per, rem = divmod(global_batch, size)
    if rem:
        raise ValueError(
            f"the data-parallel size {size} must divide the global batch "
            f"size {global_batch} (each process contributes an equal row "
            f"slice)")
    return index * per, (index + 1) * per


def draw_order(seed, n, out=None):
    """numpy's RandomState(seed).permutation(n), bit for bit, into `out`
    (int64 [n]; a new array for None): the native port, which releases the
    GIL, else numpy with a warning. A seed numpy refuses raises numpy's
    ValueError."""
    seed = operator.index(seed)
    if not 0 <= seed <= 0xFFFFFFFF:
        np.random.RandomState(seed)          # raises numpy's own ValueError
    if out is None:
        out = np.empty((n,), np.int64)
    try:
        return native.permutation(seed, n, out)
    except (OSError, RuntimeError) as e:
        warnings.warn(f"native epoch order failed ({e}); drawing it with "
                      f"numpy")
    out[:] = np.random.RandomState(seed).permutation(n)
    return out


class _Ahead:
    """The order of a coming epoch, drawn in a worker thread into a host
    tensor (pinned where it goes on to the card). `key` is (seed, epoch,
    rows)."""

    def __init__(self, key, out):
        self.key, self.out, self.error = key, out, None
        self.thread = threading.Thread(target=self._draw, daemon=True,
                                       name="armnet-order")
        self.thread.start()

    def _draw(self):
        seed, epoch, n = self.key
        try:
            with span("armnet.feed.order_draw", epoch=epoch):
                draw_order(seed + epoch, n, self.out.numpy())
        except Exception as e:   # the epoch redraws, and raises, on its own
            self.error = e

    def take(self):
        """The order, or None where the draw failed."""
        self.thread.join()
        return self.out if self.error is None else None


def _order_tensor(n, pinned):
    return torch.empty((n,), dtype=torch.int64, pin_memory=pinned)


def _broadcast_ids(ds):
    """Whether the ids are one row broadcast over the rows (the UCI sets)."""
    return ds.ids.ndim == 2 and ds.ids.strides[0] == 0


def resident_bytes(ds):
    """The device bytes of a dataset's resident columns and of one epoch's
    order: ids, values, labels and mask with a pad row, int64 order."""
    n, f = len(ds), ds.nfield
    ids = 2 * f * 4 if _broadcast_ids(ds) else (n + 1) * f * 4
    return ids + (n + 1) * (f * 4 + 4 + 4) + n * 8


def _on_cuda(device):
    return device is not None and device.type == "cuda"


def resident_fits(ds, device):
    """Whether the dataset's rows go to the device: a CUDA device whose
    free memory holds them within RESIDENT_SHARE of it."""
    if not _on_cuda(device):
        return False
    free, _ = torch.cuda.mem_get_info(device)
    return resident_bytes(ds) <= RESIDENT_SHARE * free


def _upload(arr, pad, device):
    """arr [N, ...] with the row `pad` appended, as a tensor on device."""
    with warnings.catch_warnings():
        # a read-only memmap of the row cache: read, never written
        warnings.filterwarnings("ignore", message=".*not writable")
        src = torch.from_numpy(np.ascontiguousarray(arr))
    out = torch.empty((src.shape[0] + 1, *src.shape[1:]), dtype=src.dtype,
                      device=device)
    out[:-1].copy_(src)
    out[-1] = pad
    return out


class _Resident:
    """A dataset's rows on a device, each column with one pad row at index
    n (id 0, value 1.0, label 0, mask 0): a batch is index_select of the
    columns at its slice of the epoch's order. Broadcast ids keep two rows
    (the pad's zeros, the broadcast row), selected by the batch's mask."""

    def __init__(self, ds, device):
        self.ds, self.n = ds, len(ds)
        f = ds.nfield
        self.broadcast = _broadcast_ids(ds)
        if self.broadcast:
            self.ids = torch.zeros((2, f), dtype=torch.int32, device=device)
            if self.n:
                self.ids[1] = torch.from_numpy(np.array(ds.ids[0]))
        else:
            self.ids = _upload(ds.ids, 0, device)
        self.values = _upload(ds.values, 1.0, device)
        self.labels = _upload(ds.labels, 0.0, device)
        self.mask = torch.ones((self.n + 1,), dtype=torch.float32,
                               device=device)
        self.mask[self.n] = 0.0

    def take(self, idx):
        """The batch at row indices idx (int64 on the device; n is the pad
        row)."""
        mask = self.mask.index_select(0, idx)
        ids = (self.ids.index_select(0, mask.long()) if self.broadcast
               else self.ids.index_select(0, idx))
        return {"id": ids, "value": self.values.index_select(0, idx),
                "y": self.labels.index_select(0, idx), "mask": mask}


class _Staged:
    """A batch on its way to the device: the device tensors, the copy's
    event, and the pinned host tensors it is copied from."""

    __slots__ = ("batch", "event", "pinned")

    def __init__(self, batch, event=None, pinned=None):
        self.batch, self.event, self.pinned = batch, event, pinned


class BatchIterator:
    """Fixed-shape batches, in input order or shuffled per epoch, as tensors
    on `device` (CPU tensors for None or a CPU device).

    local_shard_total: the dataset holds only this process's byte-range
    shard, and this is the GLOBAL row count, from which every process
    derives the same number of batches. data_parallel=(index, size): each
    batch holds this process's rows of the global batch (from the local
    shard with local_shard_total, else rows [lo, hi) of each global
    batch)."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=0,
                 device=None, local_shard_total=None, data_parallel=None):
        self.ds = dataset
        self.bsz = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.device = torch.device(device) if device is not None else None
        self.local_shard_total = local_shard_total
        self.data_parallel = data_parallel
        self._copy_stream = None
        self._inflight = []          # (event, pinned) of copies in flight
        self._surplus_warned = False
        self.thread = None           # the prefetch worker of the last epoch
        self.resident = False        # the rows on the device (at iteration)
        self._rows_on_device = None  # their _Resident
        self._placed = None          # the dataset the choice was made for
        self._ahead = None           # the next epoch's order, being drawn
        self.orders_ahead = 0        # shuffled epochs that took it
        self.orders_at_start = 0     # and those that drew at their start

    def __len__(self):
        n = self.local_shard_total if self.local_shard_total else len(self.ds)
        return (n + self.bsz - 1) // self.bsz

    def _order(self, pinned):
        """The epoch's order as an int64 host tensor: the one drawn ahead
        where its key matches, else drawn now."""
        n = len(self.ds)
        if not self.shuffle:
            return torch.arange(n)
        ahead, self._ahead = self._ahead, None
        if ahead is not None and ahead.key == (self.seed, self.epoch, n):
            order = ahead.take()
            if order is not None:
                self.orders_ahead += 1
                return order
        order = _order_tensor(n, pinned)
        draw_order(self.seed + self.epoch, n, order.numpy())
        self.orders_at_start += 1
        return order

    def _place(self):
        """The resident rows, or None for the streaming path; chosen once
        for a dataset, at its first iteration."""
        if self._placed is not self.ds:
            self._placed, self._rows_on_device = self.ds, None
            self.resident = resident_fits(self.ds, self.device)
            if self.resident:
                with span("armnet.feed.upload"):
                    self._rows_on_device = _Resident(
                        self.ds, self.device or torch.device("cpu"))
        return self._rows_on_device

    def _rows(self, idx, lo, hi):
        """numpy rows [lo, hi) of the padded batch whose real rows are idx."""
        take = idx[lo:min(hi, idx.shape[0])]
        n, size = take.shape[0], hi - lo
        ids = self.ds.ids[take]
        values = self.ds.values[take]
        y = self.ds.labels[take]
        mask = np.ones((size,), np.float32)
        if n < size:
            pad = size - n
            ids = np.concatenate(
                [ids, np.zeros((pad, self.ds.nfield), np.int32)])
            values = np.concatenate(
                [values, np.ones((pad, self.ds.nfield), np.float32)])
            y = np.concatenate([y, np.zeros((pad,), np.float32)])
            mask[n:] = 0.0
        return {"id": np.ascontiguousarray(ids),
                "value": np.ascontiguousarray(values),
                "y": np.ascontiguousarray(y), "mask": mask}

    def _stage(self, host, epoch, b):
        """Start the copy of batch b of the epoch to the device (a CUDA
        device: pinned memory, non_blocking, on the copy stream)."""
        if self.device is None or self.device.type != "cuda":
            batch = {k: torch.from_numpy(v) for k, v in host.items()}
            if self.device is not None:
                batch = {k: v.to(self.device) for k, v in batch.items()}
            return _Staged(batch)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with span("armnet.feed.pin", epoch=epoch, batch=b):
            pinned = {k: torch.from_numpy(v).pin_memory()
                      for k, v in host.items()}
        with (span("armnet.feed.copy", epoch=epoch, batch=b),
              torch.cuda.stream(self._copy_stream)):
            batch = {k: v.to(self.device, non_blocking=True)
                     for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return _Staged(batch, event, pinned)

    def _hand_over(self, staged):
        """The batch, safe to use on the current stream."""
        if staged.event is None:
            return staged.batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(staged.event)
        for t in staged.batch.values():
            t.record_stream(stream)
        # the pinned source lives until the host sees its copy complete
        self._inflight = [(e, p) for e, p in self._inflight
                          if not e.query()]
        self._inflight.append((staged.event, staged.pinned))
        return staged.batch

    def _release(self, epoch):
        with span("armnet.feed.release", epoch=epoch):
            if self._copy_stream is not None:
                self._copy_stream.synchronize()
            self._inflight = []

    def _plan(self, pinned):
        """(order, number of batches, rows drawn per batch, [lo, hi) of the
        global batch this process holds); a shuffled epoch starts drawing
        the next one's order."""
        with span("armnet.feed.order", epoch=self.epoch):
            order = self._order(pinned)
        self.epoch += 1
        if self.shuffle:
            n = len(self.ds)
            self._ahead = _Ahead((self.seed, self.epoch, n),
                                 _order_tensor(n, pinned))
        nb = len(self)
        lo, hi = (0, self.bsz) if self.data_parallel is None else (
            _process_local_rows(self.bsz, *self.data_parallel))
        step = self.bsz
        if self.local_shard_total:
            step = hi - lo
            # byte-range shards are uneven: rows past nb * step cannot be
            # drawn this epoch (the batch geometry is fixed across
            # processes); with shuffle a different set each epoch
            surplus = len(self.ds) - nb * step
            if surplus > 0 and not self._surplus_warned:
                self._surplus_warned = True
                warnings.warn(
                    f"local shard holds {surplus} more rows than the epoch's "
                    f"{nb} global batches consume ({step}/process/batch); "
                    f"{'a different ' if self.shuffle else 'the SAME '}"
                    f"{surplus} rows are skipped each epoch "
                    f"(shuffle={self.shuffle})")
        return order, nb, step, (lo, hi)

    def _load(self, epoch, order, b, step, lo, hi):
        """Batch b of the epoch, gathered on the host and staged."""
        with span("armnet.feed.gather", epoch=epoch, batch=b):
            idx = order[b * step:(b + 1) * step]
            host = (self._rows(idx, 0, hi - lo) if self.local_shard_total
                    else self._rows(idx, lo, hi))
        staged = self._stage(host, epoch, b)
        # after a pinned copy this frees the batch's host rows (20 MB at
        # 65,536 Criteo rows: milliseconds of the host's time)
        with span("armnet.feed.free", epoch=epoch, batch=b):
            del host
        return staged

    def _device_order(self, order, nb, step):
        """The epoch's order on the device, its tail past the rows (up to
        nb * step) pointing at the pad row, and the event the consumer
        waits on (None where no copy stream is used)."""
        n = order.shape[0]
        total = max(n, nb * step)
        if not _on_cuda(self.device):
            full = torch.full((total,), n, dtype=torch.int64)
            full[:n] = order
            return full, None
        if not self.shuffle:
            return torch.arange(total, device=self.device).clamp_(max=n), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty((total,), dtype=torch.int64, device=self.device)
            dev[:n].copy_(order, non_blocking=True)
            if total > n:
                dev[n:].fill_(n)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev, event

    def _iter_resident(self, rows, epoch, order, nb, step, lo, hi):
        size = hi - lo
        first = 0 if self.local_shard_total else lo
        dev, event = self._device_order(order, nb, step)
        for b in range(nb):
            with span("armnet.feed.take", epoch=epoch, batch=b):
                if event is not None:
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(event)
                    dev.record_stream(stream)
                start = b * step + first
                batch = rows.take(dev[start:start + size])
            yield batch

    def __iter__(self):
        epoch = self.epoch
        rows = self._place()
        pinned = rows is not None and _on_cuda(self.device)
        order, nb, step, (lo, hi) = self._plan(pinned)
        if rows is not None:
            yield from self._iter_resident(rows, epoch, order, nb, step, lo,
                                           hi)
            return
        order = order.numpy()
        if (os.environ.get("ARMNET_PREFETCH_THREAD", "0") == "1"
                and not multi_process()):
            yield from self._iter_threaded(epoch, order, nb, step, lo, hi)
            return
        pending = None
        try:
            for b in range(nb):
                nxt = self._load(epoch, order, b, step, lo, hi)
                if pending is not None:
                    yield self._hand_over(pending)
                pending = nxt
            if pending is not None:
                yield self._hand_over(pending)
        finally:
            self._release(epoch)

    def _iter_threaded(self, epoch, order, nb, step, lo, hi):
        q = queue.Queue(maxsize=2)
        stop = threading.Event()

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    q.put(self._load(epoch, order, b, step, lo, hi))
                q.put(None)                      # end of the epoch
            except BaseException as e:           # raised on the main thread
                q.put(e)

        self.thread = threading.Thread(target=worker, daemon=True,
                                       name="armnet-prefetch")
        self.thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._hand_over(item)
        finally:
            stop.set()
            # unblock a worker waiting on a full queue, then reap it
            while self.thread.is_alive():
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
                self.thread.join(timeout=0.05)
            self._release(epoch)


def _global_row_counts(counts, group):
    """The local row counts summed over the data group (one all-reduce)."""
    return [int(v) for v in all_reduce_values(counts, group, "sum")]


def make_dataloaders(dataset, data_dir, nfield, batch_size, seed=0,
                     use_cache=True, shard=None, device=None, group=None):
    """Iterators over {data_dir}/{dataset}/tr*|va*|te*libsvm: the train split
    shuffled, valid and test in input order, handing over tensors on
    `device`.

    shard=(index, size) with size > 1: multi-process mode. Each process
    parses only its byte-range shard of every split, the global row counts
    are summed over `group` (the data group: every process of it holds a
    distinct shard), and each batch holds this process's batch_size / size
    rows of the global batch."""
    base = os.path.join(data_dir, dataset)

    def pick(prefix):
        matches = sorted(glob.glob(os.path.join(base, f"{prefix}*libsvm")))
        if not matches:
            raise FileNotFoundError(
                f"no {prefix}*libsvm under {base} (expected the tr/va/te "
                f"naming convention)")
        return matches[0]

    if shard is not None and shard[1] > 1:
        sets = [LibsvmDataset(pick(p), nfield, use_cache, shard=shard)
                for p in ("tr", "va", "te")]
        totals = _global_row_counts([len(s) for s in sets], group)
        return tuple(BatchIterator(s, batch_size, i == 0, seed, device,
                                   local_shard_total=t, data_parallel=shard)
                     for i, (s, t) in enumerate(zip(sets, totals)))
    return tuple(BatchIterator(LibsvmDataset(pick(p), nfield, use_cache),
                               batch_size, p == "tr", seed, device)
                 for p in ("tr", "va", "te"))
