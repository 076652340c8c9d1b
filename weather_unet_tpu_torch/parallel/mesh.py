"""Device mesh, placement and the data-parallel collectives -- the port of
``weather_unet_tpu/parallel/mesh.py``.

The JAX package shards the batch over a ``'data'`` axis of one SPMD
program and lets XLA insert the gradient ``psum``.  Here one process is one
rank: a :class:`MeshPlan` is a (data, model) grid over the world's ranks
times this process's devices, each rank loads its data row's rows of the
global batch, and the steps all-reduce their gradients in one flat bucket
per network over the ranks' data group (:func:`all_reduce_mean`).  Without
a process group a plan describes the devices of this one process
(``api.py`` keeps a replica of the model, or with ``tensor_parallel`` one
shard, on each).

Under a process group rank r sits at grid position ``(r // model, r %
model)`` (``launch.data_index`` / ``launch.model_index``), and
:func:`make_mesh` makes each rank's two groups: its **model group** (the
ranks of its data row, over which ``parallel/tp.py`` sums the split conv
pairs) and its **data group** (the ranks of its model column, over which
the gradients, the evaluation sums and BatchNorm's moments go).  Without
tensor parallelism each model position holds a full replica and steps on
its data row's rows, as in the JAX package.

Spatial partitioning uses the same grid: :meth:`MeshPlan.spatial` places
NHWC images with the batch over the data rows and the height over the
model axis, cut at multiples of the deepest feature map's stride
(:func:`row_cut`), and ``parallel/spatial.py`` runs the networks on the
shards, one rank a shard over the model group, or in threads of one
process.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from weather_unet_tpu_torch.parallel import launch


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A (data, model) grid over ``process_count`` ranks times each rank's
    devices, rank-major: rank r holds global positions ``[r * k, (r + 1) *
    k)`` of the ``data * model`` grid, k = ``len(devices)``.  ``devices``
    are this process's devices in the grid."""

    shape: Tuple[int, int]
    devices: Tuple[torch.device, ...]
    process_count: int = 1
    process_index: int = 0

    @property
    def mesh_shape(self) -> dict:
        """The axes as the JAX package's ``plan.mesh.shape`` names them."""
        return {"data": self.shape[0], "model": self.shape[1]}

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_model(self) -> int:
        return self.shape[1]

    def batch(self) -> "Sharding":
        return Sharding(self, ("data",))

    def replicated(self) -> "Sharding":
        return Sharding(self, ())

    def rows(self) -> list:
        """This process's devices by data row: one list of ``n_model``
        devices for each data row the process holds."""
        m = self.n_model
        return [list(self.devices[i:i + m])
                for i in range(0, len(self.devices), m)]

    def spatial(self, input_size: Optional[int] = None,
                deepest_stride: int = 16) -> "Sharding":
        """Batch over ``'data'`` and image height over ``'model'``: NHWC
        images split like the JAX package's ``P("data", "model", None,
        None)``, the rows cut at multiples of ``deepest_stride``
        (:func:`row_cut`), so every feature map down to the deepest
        (cUNet: H/8; SNDisc: H/16, hence the default) holds whole rows on
        every shard.  The JAX package's guard, with its message: a model
        axis larger than the deepest feature map's height
        (``input_size // deepest_stride``) is refused; without
        ``input_size`` nothing is checked here (the placement cuts what it
        is given)."""
        n_model = self.n_model
        if input_size is not None and n_model > max(
                input_size // deepest_stride, 1):
            raise ValueError(
                f"spatial partitioning degree {n_model} exceeds the deepest "
                f"feature-map height {input_size // deepest_stride} "
                f"(input_size={input_size}, deepest_stride={deepest_stride}); "
                f"use a smaller 'model' axis or a larger input")
        return Sharding(self, ("data", "model"), deepest_stride)


def require_model_axis(plan: Optional["MeshPlan"],
                       what: str = "a mesh") -> None:
    """The JAX package's guard: ``tensor_parallel`` needs a plan whose
    model axis has at least two devices (``what`` names the plan as the
    caller's message does)."""
    if plan is None or plan.n_model < 2:
        raise ValueError(
            f"tensor_parallel requires {what} with a 'model' axis of >= 2 "
            f"devices (make_mesh(model=K))")


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a tree is laid out over a plan: ``("data",)`` splits dimension 0
    by rank and then over the rank's devices, ``()`` copies it to each,
    ``("data", "model")`` splits an NHWC leaf's dimension 0 over the data
    rows and its dimension 1 (height) over the model axis, cut at
    multiples of ``unit`` rows (:func:`row_cut`)."""

    plan: MeshPlan
    spec: tuple
    unit: int = 1


def row_cut(height: int, n: int, unit: int = 16) -> list:
    """``(start, rows)`` of each of ``n`` shards of ``height`` rows: cuts at
    multiples of ``unit``, as even as that allows (shard k starts at
    ``unit * floor(k * units / n)``: 224 rows at degree 4 and unit 16 are
    48/64/48/64), so that a feature map ``unit`` times smaller still holds
    whole rows on every shard.  Refused where a shard would hold none or
    ``height`` is not a multiple of ``unit``."""
    units = height // unit if unit else 0
    if n < 1 or units * unit != height or units < n:
        raise ValueError(
            f"{height} rows do not cut into {n} shard(s) of whole "
            f"multiples of {unit} rows")
    starts = [unit * (k * units // n) for k in range(n)] + [height]
    return [(starts[k], starts[k + 1] - starts[k]) for k in range(n)]


def estimator_cut(height: int, n: int, unit: int = 32) -> list:
    """``(start, rows)`` of each of ``n`` shards of the frozen ResNet
    estimator's ``height`` input rows, at multiples of its deepest stride
    ``unit`` (32: a cut at 16 would start a stride-2 layer on an odd row),
    as even as that allows with the larger shards first (224 rows at
    degree 2 are 128/96, at degree 4 64/64/64/32).  Where ``n`` exceeds
    the units the trailing shards hold no rows (64 rows at degree 4:
    32/32/0/0).  Refused where ``height`` is not a whole number of units."""
    units = height // unit if unit else 0
    if n < 1 or units < 1 or units * unit != height:
        raise ValueError(
            f"the estimator's {height} rows do not cut at multiples of its "
            f"deepest stride {unit}")
    q, r = divmod(units, n)
    out, start = [], 0
    for k in range(n):
        rows = unit * (q + (k < r))
        out.append((start, rows))
        start += rows
    return out


def _local_devices(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    from weather_unet_tpu_torch._device import resolve_device

    if data_parallel():
        return [resolve_device(None)]           # this rank's card (or CPU)
    resolve_device(None)                        # raises without a GPU
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1, batch_size: Optional[int] = None) -> MeshPlan:
    """Build a (data, model) plan over the world's devices: each rank's
    ``devices`` (default: this rank's card under a process group, every
    local card without one), rank-major.

    ``batch_size`` clamps the data axis to the largest divisor of the batch
    (a batch of 4 on 8 devices trains 4-way), as the JAX package does; its
    refusals, with its messages: a model axis larger than the devices, a
    grid that does not fit, and a multi-process grid that leaves a device
    out."""
    local = _local_devices(devices)
    pc, pid = launch.process_count(), launch.process_index()
    n = len(local) * pc
    if model < 1 or model > n:
        raise ValueError(
            f"model axis {model} does not fit the {n} available "
            f"device(s); reduce --tensor_parallel / the spatial degree or "
            f"run on a larger slice")
    if data is None:
        data = n // model
        if batch_size is not None:
            while data > 1 and batch_size % data != 0:
                data -= 1
    if data < 1 or data * model > n:
        raise ValueError(
            f"mesh (data={data} x model={model}) does not fit the "
            f"{n} available device(s)")
    if pc > 1 and data * model != n:
        raise ValueError(
            f"multi-process mesh must span all {n} devices, got "
            f"data={data} x model={model}"
            + (f" (batch_size={batch_size} is not divisible by the device "
               f"count)" if batch_size is not None else ""))
    k = len(local)
    mine = [d for i, d in enumerate(local) if pid * k + i < data * model]
    if pc > 1 and k == 1:
        # one device a rank: the ranks themselves form the grid
        launch.set_grid(data, model)
        _make_groups(data, model)
    return MeshPlan((data, model), tuple(mine), pc, pid)


# (data, model) -> this rank's (model group, data group), each a (process
# group or None for the world, its ranks) pair
_GROUPS: dict = {}


def _make_groups(data: int, model: int) -> None:
    """Make the grid's model groups (one a data row) and data groups (one a
    model column); every rank makes every group, in one order, as
    ``torch.distributed.new_group`` requires.  A group of one rank or of
    the whole world gets no group of its own."""
    if (data, model) in _GROUPS:
        return
    d = torch.distributed
    world, rank = data * model, d.get_rank()

    def make(rank_sets):
        mine = None
        for ranks in rank_sets:
            pg = (d.new_group(ranks) if 1 < len(ranks) < world else None)
            if rank in ranks:
                mine = (pg, ranks)
        return mine

    _GROUPS[(data, model)] = (
        make([list(range(i * model, (i + 1) * model))
              for i in range(data)]),
        make([list(range(m, world, model)) for m in range(model)]))


def _groups():
    grid = launch._grid()
    if grid in _GROUPS:
        return _GROUPS[grid]
    # no grid with a model axis: every rank its own data row
    rank = launch.process_index()
    return (None, [rank]), (None, list(range(launch.process_count())))


def model_group() -> tuple:
    """This rank's model group: ``(process group or None for the world,
    its ranks)``, the ranks of its data row."""
    return _groups()[0]


def data_group() -> tuple:
    """This rank's data group: ``(process group or None for the world, its
    ranks)``, the ranks of its model column."""
    return _groups()[1]


def batch_sharding(plan: MeshPlan) -> Sharding:
    return plan.batch()


def replicated_sharding(plan: MeshPlan) -> Sharding:
    return plan.replicated()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def _place_spatial(plan: MeshPlan, unit: int, t: torch.Tensor) -> list:
    """An NHWC leaf over the local devices: this process's rows split over
    its data rows, each data row's images cut by height over the model
    axis (the device at grid position p holds data row ``p // model``'s
    images, rows ``row_cut[p % model]``)."""
    if t.dim() != 4:
        raise ValueError(f"spatial placement takes NHWC images, got shape "
                         f"{tuple(t.shape)}")
    m = plan.n_model
    first = plan.process_index * len(plan.devices)
    pos = [first + i for i in range(len(plan.devices))]
    rows = sorted({p // m for p in pos})
    if t.shape[0] % len(rows):
        raise ValueError(f"{t.shape[0]} rows do not split evenly over "
                         f"{len(rows)} data row(s)")
    chunks = dict(zip(rows, t.chunk(len(rows))))
    cut = row_cut(t.shape[1], m, unit)
    out = []
    for p, d in zip(pos, plan.devices):
        start, n = cut[p % m]
        out.append(chunks[p // m].narrow(1, start, n).to(d, copy=True)
                   .contiguous())
    return out


def _place(plan: MeshPlan, spec: tuple, x, unit: int = 1):
    """One leaf onto the plan's devices: one tensor for one device, else a
    tuple of one tensor a device (the rows split evenly for ``("data",)``,
    copies for ``()``, rows and height for ``("data", "model")``)."""
    t = _as_tensor(x)
    devs = plan.devices
    if spec == ("data", "model"):
        parts = _place_spatial(plan, unit, t)
    elif spec:
        if t.shape[0] % len(devs):
            raise ValueError(f"{t.shape[0]} rows do not split evenly over "
                             f"{len(devs)} device(s)")
        parts = [p.to(d) for p, d in zip(t.chunk(len(devs)), devs)]
    else:
        parts = [t.to(d) for d in devs]
    return parts[0] if len(parts) == 1 else tuple(parts)


def put_host_local(sharding: Sharding, tree):
    """Place this process's view of a value: for ``("data",)`` its rows as
    given (a rank's rows stay its own), for ``()`` the whole value, which
    the caller holds the same on every rank.  Nothing crosses ranks."""
    return _map(lambda x: _place(sharding.plan, sharding.spec, x,
                                 sharding.unit), tree)


def shard_batch(plan: MeshPlan, tree):
    """Place a global batch: this rank's ``process_slice`` of each leaf's
    rows onto its device(s)."""
    def one(x):
        t = _as_tensor(x)
        return _place(plan, ("data",), t[launch.process_slice(t.shape[0])])

    return _map(one, tree)


def replicate(plan: MeshPlan, tree):
    """Place a value on the plan's devices as rank 0 holds it: each leaf is
    broadcast from rank 0 under a process group."""
    def one(x):
        t = _as_tensor(x).to(plan.devices[0], copy=True)
        broadcast_([t])
        return _place(plan, (), t)

    return _map(one, tree)


# --------------------------------------------------------------- collectives
#
# Built from ``broadcast`` and ``all_reduce`` alone: gloo carries CUDA
# tensors for those two and for nothing else.

def data_parallel() -> bool:
    """True under a process group: the steps all-reduce their gradients."""
    d = torch.distributed
    return d.is_available() and d.is_initialized()


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place (a no-op without
    a process group)."""
    if not data_parallel():
        return
    for t in tensors:
        torch.distributed.broadcast(t.data, src)


def broadcast_module_(module: torch.nn.Module) -> None:
    """The first rank of this rank's data group's parameters and buffers
    into ``module``, in place: rank 0's without a model axis, and under
    tensor parallelism the rank holding the same shard in data row 0."""
    pg, ranks = data_group()
    if len(ranks) > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            torch.distributed.broadcast(t.data, ranks[0], group=pg)


def _reduces() -> bool:
    """True where a data-group all-reduce has work: a group of several
    ranks, or the world of one rank that ``launch -n 1`` makes."""
    if not data_parallel():
        return False
    _, ranks = data_group()
    return len(ranks) > 1 or launch.process_count() == 1


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> list:
    """The mean over this rank's data group of each tensor, through one flat
    float32 bucket and one ``all_reduce``: ``SUM``, then a division by the
    group's size (gloo has no ``AVG``).  Without a model axis the group is
    the world; under tensor parallelism the ranks holding the same shard,
    whose gradients are of the same slice.  Returns new tensors, each in
    its input's dtype and shape (float32 ones are views of the bucket)."""
    tensors = list(tensors)
    if not tensors or not _reduces():
        return tensors
    pg, ranks = data_group()
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    torch.distributed.all_reduce(flat, group=pg)
    flat.div_(len(ranks))
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].view(t.shape).to(t.dtype))
        at += n
    return out


class _AllReduceSum(torch.autograd.Function):
    """``all_reduce(SUM)`` over the data group whose gradient is the same
    all-reduce of the incoming gradients: y = sum over ranks of x, so each
    x's gradient sums every rank's gradient of y."""

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        torch.distributed.all_reduce(y, group=data_group()[0])
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g, group=data_group()[0])
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the data group, differentiable (``BatchNorm2d``'s
    moments under a plan of several data rows)."""
    if not _reduces():
        return x
    return _AllReduceSum.apply(x)
