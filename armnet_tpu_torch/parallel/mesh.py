"""Process mesh over torch.distributed (port of armnet_tpu/parallel/mesh.py).

The two axes of the JAX package: 'data' (each data row of processes trains
on its own rows of the global batch; gradients are summed over the data
group) and 'model' (each model rank holds a row block of every sharded
embedding table). A process is one rank and one device. Ranks take their
(data, model) coordinates row-major in the spec's axis order, as the JAX
mesh reshapes its device list. Bring-up goes through
maybe_initialize_distributed, from torchrun's environment.
"""

import math
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "MODEL_AXIS", "parse_mesh_spec", "make_mesh", "Mesh",
           "maybe_initialize_distributed", "multi_process", "all_reduce_values",
           "all_reduce_sum", "all_gather_cat"]

DATA_AXIS = "data"
MODEL_AXIS = "model"
_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


def parse_mesh_spec(spec):
    """'data:4,model:2' -> dict. Empty spec -> all devices on 'data'.
    A size of -1 means 'all remaining devices'."""
    if not spec:
        return {DATA_AXIS: -1}
    out = {}
    for part in spec.split(","):
        name, _, size = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"bad mesh spec {spec!r}")
        if name in out:
            raise ValueError(f"duplicate axis {name!r} in mesh spec {spec!r}")
        n = int(size) if size else -1
        if n == 0 or n < -1:
            raise ValueError(
                f"axis {name!r} size must be positive or -1 (got {n}) in "
                f"mesh spec {spec!r}")
        out[name] = n
    return out


class Mesh:
    """This rank's place on the mesh and the process groups along it.

    shape: {axis: size} in the spec's order; rank, world_size; data_index,
    model_index (0 on an absent axis); data_group (the ranks that differ
    from this one in the data coordinate only) and model_group (the model
    coordinate only): None without an initialized process group, where
    the mesh is one process and no collective runs."""

    def __init__(self, shape, rank, groups):
        self.shape = dict(shape)
        self.rank = rank
        self.world_size = math.prod(self.shape.values())
        coords = dict(zip(self.shape, np.unravel_index(
            rank, tuple(self.shape.values()))))
        self.data_index = int(coords.get(DATA_AXIS, 0))
        self.model_index = int(coords.get(MODEL_AXIS, 0))
        self.data_group, self.model_group = groups

    @property
    def data_size(self):
        return self.shape.get(DATA_AXIS, 1)

    @property
    def model_size(self):
        return self.shape.get(MODEL_AXIS, 1)

    @property
    def distributed(self):
        return self.data_group is not None

    def __repr__(self):
        return (f"Mesh({self.shape}, rank {self.rank}: data "
                f"{self.data_index}, model {self.model_index})")


def _axis_groups(shape, axis):
    """Rank lists of the groups along `axis`: the ranks that share every
    other coordinate, row-major."""
    grid = np.arange(math.prod(shape.values())).reshape(tuple(shape.values()))
    if axis not in shape:
        return [[int(r)] for r in grid.reshape(-1)]
    k = list(shape).index(axis)
    return [[int(r) for r in row]
            for row in np.moveaxis(grid, k, -1).reshape(-1, shape[axis])]


def make_mesh(spec="", world_size=None, rank=None):
    """The Mesh of a spec over the initialized process group (world size and
    rank default to its), or over one process without one. Axis sizes come
    from the spec; one -1 takes the rest of the world size, whose product
    must equal it. Every rank must call this, in the same order: it creates
    the data and model groups collectively."""
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if rank is None:
        rank = dist.get_rank() if initialized else 0
    axes = parse_mesh_spec(spec)
    unknown = set(axes) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise ValueError(f"mesh spec {spec!r} names {sorted(unknown)}; the "
                         f"axes are {DATA_AXIS!r} and {MODEL_AXIS!r}")
    known = math.prod(s for s in axes.values() if s != -1)
    wild = [name for name, s in axes.items() if s == -1]
    if len(wild) > 1:
        raise ValueError("only one axis may have size -1")
    if wild:
        if world_size % known:
            raise ValueError(f"{world_size} processes not divisible by "
                             f"{known}")
        axes[wild[0]] = world_size // known
    total = math.prod(axes.values())
    if total != world_size:
        raise ValueError(f"mesh {axes} needs {total} processes, have "
                         f"{world_size}")
    groups = (None, None)
    if initialized:
        found = []
        for axis in (DATA_AXIS, MODEL_AXIS):
            mine = None
            for ranks in _axis_groups(axes, axis):
                g = dist.new_group(ranks)        # collective: every rank
                if rank in ranks:
                    mine = g
            found.append(mine)
        groups = tuple(found)
    return Mesh(axes, rank, groups)


def maybe_initialize_distributed(device="cuda"):
    """init_process_group from torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT, LOCAL_RANK): NCCL on cuda:LOCAL_RANK (made
    the current device) for a CUDA `device`, gloo for the CPU. Returns
    whether it started the process group: False without that environment
    or where a group is already up. Raises ValueError on a half-set
    environment, where this process would otherwise wait at the
    rendezvous with a wrong identity while the others block."""
    present = {k: os.environ.get(k) for k in _ENV}
    if not any(present.values()):
        return False
    missing = [k for k, v in present.items() if v is None]
    if missing:
        raise ValueError(
            f"set all of {', '.join(_ENV)} (torchrun sets them) or none; "
            f"missing {missing}")
    if dist.is_initialized():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(present["LOCAL_RANK"]))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(present["WORLD_SIZE"]),
                            rank=int(present["RANK"]))
    return True


def multi_process():
    """Whether this process is one of several in a process group."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def all_reduce_values(values, group, op="sum"):
    """A list of numbers reduced ('sum' or 'max') over `group` in one
    all-reduce, as float64 on the host; the values themselves without an
    initialized process group. The tensor goes to the current CUDA device
    under NCCL."""
    if not (dist.is_available() and dist.is_initialized()):
        return list(values)
    on = "cpu"
    if dist.get_backend(group) == "nccl":
        on = torch.device("cuda", torch.cuda.current_device())
    t = torch.tensor(list(values), dtype=torch.float64, device=on)
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return t.cpu().tolist()


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward is the same sum of the gradients:
    every member's output feeds its own part of one loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x, group):
    """Differentiable sum of x over `group`; x itself where group is None."""
    return x if group is None else _AllReduceSum.apply(x, group)


def all_gather_cat(x, group):
    """x of every member of `group` concatenated along dim 0 in group-rank
    order (no gradient); x itself where group is None."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
