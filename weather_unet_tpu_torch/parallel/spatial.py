"""Spatial partitioning: image height split over the plan's ``'model'``
axis -- the port of what the JAX package leaves to XLA's SPMD partitioner
under ``MeshPlan.spatial`` (``weather_unet_tpu/parallel/mesh.py``).

The JAX package places NHWC images with ``P("data", "model", None,
None)`` and jits the unchanged forward or train step; the partitioner
inserts the conv halo exchanges and turns AdaIN's per-image reductions,
the upsample's matmuls and the losses' means into collectives.  PyTorch
runs eagerly, so the port writes each of those collectives where the
layer needs it, and marks the modules that take part (:func:`spatial_`,
as ``parallel/tp.py::shard_`` marks a split):

* **halo exchange** (:meth:`SpatialGroup.halo`): a 3x3 pad-1 conv takes
  its neighbours' edge row above and below (zero rows at the image's top
  and bottom) and convolves with padding ``(0, 1)``; the SNDisc's
  stride-2 conv takes the row above only (every shard starts on an even
  row).  Its backward sends the halo rows' gradients back to their owners.
* **sums** over the shards of one data row (:meth:`SpatialGroup.sum`),
  with a summing backward: the SNDisc's global sum pool, the losses'
  pixel means (``ops/losses.py``).
* **gathers** (:meth:`SpatialGroup.gather_rows`): whole rows for the
  frozen estimator, AdaIN's local plane statistics for their exact merge
  (``ops/norm.py::adain_split``; K1's split form with ``use_pallas``);
  the backward is a sum over the shards followed by the shard's own slice.
* the align-corners upsample of a shard's rows with one halo row each side
  (``ops/resize.py::upsample_x2_rows``; K2's row-window form with
  ``use_pallas``); max-pool stays local.

Rows are cut at multiples of the deepest stride (``mesh.row_cut``: 224 at
degree 4 is 48/64/48/64), so every level of both networks holds whole,
even rows on every shard.  Parameters are replicated.  The gradient rule,
which holds everywhere: every cross-shard sum has a summing backward, each
shard backpropagates the replicated loss divided by the degree, and each
parameter's gradient is summed over the data row's shards
(``train/gan.py``).  Dropout masks are the unsharded mask's rows: each
shard draws the whole mask from the same generator and keeps its rows.

The group is one of ``parallel/tp.py``'s two kinds: ``ThreadShards`` (the
shards in threads of one process, without autograd, as a serving forward
runs) or ``ProcessShards`` (one rank a shard, with autograd: the GAN step).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from weather_unet_tpu_torch.parallel import mesh, tp


class SpatialGroup:
    """The shards of one data row under spatial partitioning of images of
    ``input_size`` rows: shard k holds rows ``cut[k] = (start, rows)``
    (``mesh.row_cut`` at ``unit``).  ``shards`` is a ``tp.ThreadShards``
    or ``tp.ProcessShards`` of the row.  ``exchanges`` counts the
    collectives this shard took part in (each counted once)."""

    def __init__(self, shards: tp.Shards, input_size: int,
                 unit: int = 16):
        self.shards = shards
        self.n = shards.n
        self.input_size = input_size
        self.cut = mesh.row_cut(input_size, self.n, unit)

    @property
    def index(self) -> int:
        return self.shards.index

    @property
    def exchanges(self) -> int:
        return self.shards.sums

    def level(self, h: int) -> Tuple[int, int]:
        """``(start, total)`` of this shard's rows at a level where it holds
        ``h`` rows: its first row and the image's rows there."""
        start, rows = self.cut[self.index]
        f = rows // h
        if h < 1 or f * h != rows or self.input_size % f:
            raise ValueError(f"{h} rows are no level of shard "
                             f"{self.index}'s {rows} input rows")
        return start // f, self.input_size // f

    def rows_at(self, h: int) -> List[int]:
        """Every shard's rows at the level where this one holds ``h``."""
        f = self.cut[self.index][1] // h
        return [rows // f for _, rows in self.cut]

    # ------------------------------------------------------- collectives
    def halo(self, xs: Sequence[Optional[torch.Tensor]], above: int = 1,
             below: int = 1) -> list:
        """Each (B, C, h, W) tensor of ``xs`` with ``above`` rows of the
        shard above on top and ``below`` rows of the shard below under it
        (zeros beyond the image), all in one exchange; differentiable."""
        keep = [x for x in xs if x is not None]
        out = iter(_Halo.apply(self, above, below, *keep))
        return [None if x is None else next(out) for x in xs]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the shards, in float32, in ``t``'s dtype;
        its gradient summed over the shards too."""
        return _Sum.apply(t, self)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole image's rows (dim 2) from every shard's, in order;
        the backward sums the gradient over the shards and keeps this
        shard's rows."""
        return _Gather.apply(x, self, 2, tuple(self.rows_at(x.shape[2])))

    def stack(self, t: torch.Tensor) -> torch.Tensor:
        """Every shard's ``t`` (same shape on each), stacked on a new dim
        0; the backward as :meth:`gather_rows`'."""
        return _Gather.apply(t[None], self, 0, (1,) * self.n)

    def pixel_mean(self, t: torch.Tensor, dims: Tuple[int, ...]):
        """``t.mean(dims)`` of the whole image, ``dims`` including the row
        dim 2: the shards' float32 sums summed, over the whole image's
        count; in ``t``'s dtype."""
        _, total = self.level(t.shape[2])
        count = 1
        for d in dims:
            count *= total if d == 2 else t.shape[d]
        return (self.sum(t.float().sum(dim=dims)) / count).to(t.dtype)

    # -------------------------------------------------------- the layers
    def conv_input(self, x, skip, stride: int, padding) -> tuple:
        """The halo'd inputs of a 3x3 pad-1 conv and its padding: one row
        above and below at stride 1, the row above at stride 2."""
        ph, pw = _pair(padding)
        if ph != 1 or stride not in (1, 2):
            raise ValueError(f"a spatially split conv takes padding 1 and "
                             f"stride 1 or 2, got {padding}, {stride}")
        x, skip = self.halo((x, skip), 1, 1 if stride == 1 else 0)
        return x, skip, (0, pw)

    def upsample(self, x: torch.Tensor, use_pallas: bool) -> torch.Tensor:
        """The 2x align-corners upsample of this shard's rows: its rows of
        the whole image's output, from a slab with one halo row each side
        (K2's row-window form with ``use_pallas``)."""
        from weather_unet_tpu_torch.kernels.upsample import (
            upsample2x_rows_fused)
        from weather_unet_tpu_torch.ops.resize import upsample_x2_rows

        start, total = self.level(x.shape[2])
        (slab,) = self.halo((x,), 1, 1)
        up = upsample2x_rows_fused if use_pallas else upsample_x2_rows
        return up(slab, total, start)

    def adain(self, x: torch.Tensor, y_proj: torch.Tensor, eps: float,
              use_pallas: bool) -> torch.Tensor:
        """AdaIN whose plane statistics span the shards
        (``ops/norm.py::adain_split``; K1's split form with
        ``use_pallas``: the stacked statistics go straight to its apply
        launch, which merges them)."""
        from weather_unet_tpu_torch.kernels.adain import adain_split_fused
        from weather_unet_tpu_torch.ops.norm import adain_split

        counts = [r * x.shape[3] for r in self.rows_at(x.shape[2])]
        fn = adain_split_fused if use_pallas else adain_split
        return fn(x, y_proj, eps, self.stack, counts)


def _pair(v) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class _Halo(torch.autograd.Function):
    """Halo rows of several tensors in one exchange: every shard sends its
    top ``below`` and bottom ``above`` rows of each, flattened into one
    buffer; the backward sends the halo rows' gradients back the same
    way and adds them to the owners' edge rows."""

    @staticmethod
    def forward(ctx, group, above, below, *xs):
        ctx.group, ctx.above, ctx.below = group, above, below
        ctx.meta = [(x.shape, x.dtype) for x in xs]
        parts = []
        for x in xs:
            h = x.shape[2]
            if h < max(above, below):
                raise ValueError(f"{h} rows cannot give a halo of "
                                 f"{max(above, below)}")
            parts += [x[:, :, :below], x[:, :, h - above:]]
        edges = _exchange(group, parts)
        i, n = group.index, group.n
        out = []
        for t, x in enumerate(xs):
            top = (edges[i - 1][2 * t + 1] if i > 0
                   else x.new_zeros(x.shape[:2] + (above,) + x.shape[3:]))
            bot = (edges[i + 1][2 * t] if i < n - 1
                   else x.new_zeros(x.shape[:2] + (below,) + x.shape[3:]))
            out.append(torch.cat([top, x, bot], dim=2))
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        group, above, below = ctx.group, ctx.above, ctx.below
        parts = []
        for g in gs:
            hs = g.shape[2]
            parts += [g[:, :, :above], g[:, :, hs - below:]]
        back = _exchange(group, parts)
        i, n = group.index, group.n
        out = []
        for t, (g, (shape, dtype)) in enumerate(zip(gs, ctx.meta)):
            h = shape[2]
            gx = g[:, :, above:above + h].clone()
            if i < n - 1 and above:       # my bottom rows, the next's top halo
                gx[:, :, h - above:] += back[i + 1][2 * t]
            if i > 0 and below:           # my top rows, the previous' bottom
                gx[:, :, :below] += back[i - 1][2 * t + 1]
            out.append(gx.to(dtype))
        return (None, None, None, *out)


def _exchange(group: SpatialGroup, parts: Sequence[torch.Tensor]) -> list:
    """Every shard's ``parts`` (the same shapes on each shard), in one
    gather of one flat buffer: ``out[j][k]`` is shard j's ``parts[k]``."""
    dtype = parts[0].dtype
    flat = torch.cat([p.reshape(-1).to(dtype) for p in parts])
    got = group.shards.all_gather(flat)
    out = []
    for buf in got:
        at, mine = 0, []
        for p in parts:
            mine.append(buf[at:at + p.numel()].view(p.shape).to(p.dtype))
            at += p.numel()
        out.append(mine)
    return out


class _Sum(torch.autograd.Function):
    """The sum over the shards forward and backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.shards.all_sum(t.detach()).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.shards.all_sum(g.contiguous()).to(g.dtype), None


class _Gather(torch.autograd.Function):
    """Every shard's tensor joined along ``dim`` (shard j's of size
    ``sizes[j]`` there); the backward sums the gradient over the shards
    and keeps this shard's part."""

    @staticmethod
    def forward(ctx, x, group, dim, sizes):
        ctx.group, ctx.dim, ctx.sizes = group, dim, sizes
        shapes = []
        for s in sizes:
            sh = list(x.shape)
            sh[dim] = s
            shapes.append(sh)
        return torch.cat(group.shards.all_gather(x.contiguous(), shapes),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.group.index
        total = ctx.group.shards.all_sum(g.contiguous())
        start = sum(ctx.sizes[:i])
        return (total.narrow(ctx.dim, start, ctx.sizes[i]).to(g.dtype)
                .contiguous(), None, None, None)


# ------------------------------------------------------------- marking

@dataclasses.dataclass
class Layout:
    """A module marked by :func:`spatial_`: this shard ``index`` of
    ``group``."""

    group: SpatialGroup
    index: int


def layout_of(module: torch.nn.Module) -> Optional[Layout]:
    return getattr(module, "sp_layout", None)


def group_of(module: torch.nn.Module) -> Optional[SpatialGroup]:
    lay = layout_of(module)
    return None if lay is None else lay.group


def spatial_(module: torch.nn.Module, group: SpatialGroup,
             index: Optional[int] = None) -> torch.nn.Module:
    """Mark ``module`` (a cUNet or SNDisc, or any module of their layers)
    to run as shard ``index`` (default: the group's own) of ``group``: its
    3x3 convs take halos, its AdaINs split statistics, its upsamples row
    windows, its pools and means sum over the shards.  The weights are not
    touched (they are replicated).  A model with ``fuse_upconv`` levels, a
    tensor-parallel split and a second marking are refused."""
    from weather_unet_tpu_torch.models.common import SNConv, TorchConv
    from weather_unet_tpu_torch.models.cunet import (
        AdaINBlock, ConditionalUNet)
    from weather_unet_tpu_torch.models.sndisc import SNDisc

    if getattr(module, "fuse_levels", ()):
        raise ValueError(
            "fuse_upconv serving is single-device; rebuild the model "
            "with fuse_upconv=False when passing a MeshPlan")
    if tp.layout_of(module) is not None:
        raise ValueError("spatial partitioning of a tensor-parallel split "
                         "is not supported")
    if layout_of(module) is not None:
        raise ValueError("the module is spatially split already")
    index = group.index if index is None else index
    for m in module.modules():
        if isinstance(m, (TorchConv, SNConv)):
            k = (m.kernel_size[0] if isinstance(m, TorchConv)
                 else m.weight_orig.shape[2])
            if k > 1:
                m.sp = group
        elif isinstance(m, (AdaINBlock, ConditionalUNet, SNDisc)):
            m.sp = group
    module.sp_layout = Layout(group, index)
    return module


class SpatialModel:
    """A model run spatially split in this process (``ThreadShards``, no
    autograd): one copy of ``model`` on each of the plan's devices, marked
    as its data row's shard, for images of ``input_size`` rows.
    ``__call__(parts, *args)`` takes the NHWC parts that
    ``put_host_local(plan.spatial(...), x)`` places (one a device, in the
    plan's order) and further arguments placed whole on each device (or
    split by data rows where ``batched``), and returns each shard's NHWC
    output rows; ``join`` puts them back into one batch."""

    def __init__(self, model: torch.nn.Module, plan, input_size: int,
                 deepest_stride: int = 16):
        import copy

        m = plan.n_model
        if plan.process_count > 1:
            raise ValueError("an in-process spatial model takes a plan of "
                             "one process; ranks run ProcessShards")
        self.plan = plan
        self.rows = plan.rows()
        self.groups = [SpatialGroup(tp.ThreadShards(row), input_size,
                                    deepest_stride) for row in self.rows]
        self.replicas = []
        for r, row in enumerate(self.rows):
            for j, dev in enumerate(row):
                rep = copy.deepcopy(model).to(dev).eval()
                self.replicas.append(spatial_(rep, self.groups[r], j))
        self.m = m

    def __call__(self, parts, *args, batched: Sequence[bool] = ()):
        parts = parts if isinstance(parts, tuple) else (parts,)
        outs = []
        nd = len(self.rows)
        for r, group in enumerate(self.groups):
            def one(j, dev, r=r):
                k = r * self.m + j
                x = parts[k].to(dev).permute(0, 3, 1, 2).contiguous()
                extra = []
                for a, split in zip(args, list(batched) + [False] * len(
                        args)):
                    a = torch.as_tensor(a)
                    if split:
                        a = a.chunk(nd)[r]
                    extra.append(a.to(dev))
                y = self.replicas[k](x, *extra)
                if isinstance(y, tuple):
                    return y
                return y.permute(0, 2, 3, 1)
            outs += group.shards.run(one)
        return outs

    def join(self, outs) -> torch.Tensor:
        """The shards' NHWC row parts as one (B, H, W, C) batch on the first
        device: rows within a data row, data rows one after another."""
        dev = self.plan.devices[0]
        rows = [torch.cat([o.to(dev) for o in outs[r * self.m:(r + 1) *
                                                   self.m]], dim=1)
                for r in range(len(self.rows))]
        return torch.cat(rows, dim=0)


def process_group(input_size: int, deepest_stride: int = 16
                  ) -> SpatialGroup:
    """This rank's data row as a :class:`SpatialGroup` of ``ProcessShards``
    (``mesh.make_mesh`` made the model groups)."""
    return SpatialGroup(tp.process_shards(), input_size, deepest_stride)


def sum_gradients(group: SpatialGroup, grads: list) -> list:
    """The parameter gradients summed over the data row's shards, in one
    flat float32 bucket (``None`` kept)."""
    used = [i for i, g in enumerate(grads) if g is not None]
    if not used:
        return grads
    flat = torch.cat([grads[i].reshape(-1).float() for i in used])
    total = group.shards.all_sum(flat)
    out, at = list(grads), 0
    for i in used:
        n = grads[i].numel()
        out[i] = total[at:at + n].view(grads[i].shape).to(grads[i].dtype)
        at += n
    return out

