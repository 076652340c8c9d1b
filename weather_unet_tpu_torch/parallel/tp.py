"""Tensor parallelism: channel-split conv pairs over the plan's ``'model'``
axis -- the port of ``weather_unet_tpu/parallel/tp.py``.

Every compute block of both networks is a *double conv* (conv -> [act] ->
conv), which maps onto the Megatron column/row split:

* **conv1 is column-parallel**: its output channels are split over the
  model axis, and its bias and spectral-norm ``u`` (length O) with them;
* **conv2 is row-parallel**: its input channels are split, so conv1's split
  output feeds it with no reshard; its bias and ``u`` stay whole;
* **one sum over the model group follows conv2**, and conv2's bias is added
  after it.

Everything between two pairs (the decoder's AdaIN, upsample and dropout,
max-pool, ``conv_last``, the discriminator's heads) runs replicated on every
shard, so K1 and K2 run on each.

The layout rules are structural, on the port's modules: ``RDoubleConv``'s
members 0 and 2 and ``SNDoubleConv``'s 0 and 1 (the JAX package matches
path names, but the port keeps the reference's state-dict names, in which
the discriminator's *blocks* are ``conv1``..``conv4``).  A pair whose shared
width does not divide by the degree stays replicated (the discriminator's
3 -> 3 -> 64 first block); a degree that splits nothing raises, as
``tp_shardings`` does.  :func:`tp_specs` answers per state-dict key.

The split math is one implementation with the group passed in
(:class:`Split`); a group is one of two kinds:

* :class:`ProcessShards`, one rank a process (the trainers,
  ``parallel/launch.py``): the sums are ``all_reduce`` over the rank's
  model group (``mesh.model_group``).  The JAX trainer refuses tensor
  parallelism under several processes because its checkpoint reads the
  whole state back on one host; the port's trainers are multi-process by
  construction, so each save gathers the full state over the model group
  (:func:`full_state_dict`: a ``broadcast`` from each shard's owner, exact)
  and every rank writes the same bytes, and a restore slices the full tree
  (:func:`load_full_state_dict`), so one file resumes under any degree.
* :class:`ThreadShards`, the plan's devices in one process (the API and
  ``serve``): each shard runs in a thread of its own and the sums meet in
  host memory, each shard adding the partials in one order, so the
  replicated activations are equal on every shard.  One card may be named
  twice.  These shards run without autograd: a CUDA device's backward
  runs on one engine thread, which two shards of one card would share.

The three differentiable reduces: after a row-parallel conv2 a sum whose
backward is the identity (every shard computes the same loss from the
replicated sum); before a column-parallel conv1 the identity whose
backward sums (each shard holds its output channels' share of the input's
gradient); and spectral norm's sigma, summed both ways.

Partial sums are added in float32 and rounded once to the compute dtype,
with conv2's bias added before the rounding.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

# the state-dict suffixes of a split pair's members and the dimension each
# is split on (None: kept whole)
_COLUMN = {"weight": 0, "weight_orig": 0, "bias": 0, "weight_u": 0,
           "weight_v": None}
_ROW = {"weight": 1, "weight_orig": 1, "bias": None, "weight_u": None,
        "weight_v": 0}


# ------------------------------------------------------------------ layout

def conv_pairs(module: torch.nn.Module) -> list:
    """Every double conv of ``module``: ``(prefix, conv1, conv2)`` with the
    member names, ``RDoubleConv``'s 0 and 2, ``SNDoubleConv``'s 0 and 1."""
    from weather_unet_tpu_torch.models.cunet import RDoubleConv
    from weather_unet_tpu_torch.models.sndisc import SNDoubleConv

    out = []
    for prefix, m in module.named_modules():
        if isinstance(m, RDoubleConv):
            out.append((prefix, "0", "2"))
        elif isinstance(m, SNDoubleConv):
            out.append((prefix, "0", "1"))
    return out


def _width(conv: torch.nn.Module) -> int:
    w = conv.weight_orig if hasattr(conv, "weight_orig") else conv.weight
    return w.shape[0]


def _member(module, prefix: str, name: str):
    return module.get_submodule(f"{prefix}.{name}" if prefix else name)


def split_pairs(module: torch.nn.Module, n: int) -> list:
    """The pairs ``n``-way tensor parallelism splits: those whose shared
    width (conv1's output channels) divides by ``n`` (none for n = 1)."""
    if n < 2:
        return []
    return [(p, a, b) for p, a, b in conv_pairs(module)
            if _width(_member(module, p, a)) % n == 0]


def tp_specs(module: torch.nn.Module, n: int) -> Dict[str, Optional[int]]:
    """The dimension each of ``module``'s (whole) state-dict keys is split
    on under ``n``-way tensor parallelism, None where it stays whole."""
    specs: Dict[str, Optional[int]] = {k: None for k in module.state_dict()}
    for p, a, b in split_pairs(module, n):
        for member, rule in ((a, _COLUMN), (b, _ROW)):
            head = f"{p}.{member}." if p else f"{member}."
            for key in specs:
                if key.startswith(head) and key[len(head):] in rule:
                    specs[key] = rule[key[len(head):]]
    return specs


def require_split(specs_list: Sequence[dict], n: int) -> None:
    """``tp_shardings``' refusal: a degree above 1 that splits no key."""
    if n > 1 and not any(d is not None for specs in specs_list
                         for d in specs.values()):
        raise ValueError(
            f"{n}-way tensor parallelism shards NO leaf of this tree: no "
            f"conv1/conv2 channel dimension is divisible by {n}. Use a "
            f"divisor of the model's channel widths (cUNet: a power of two "
            f"<= 64) or drop --tensor_parallel")


def shard_tensor(t: torch.Tensor, dim: Optional[int], n: int,
                 index: int) -> torch.Tensor:
    """Shard ``index`` of ``n`` of ``t`` along ``dim`` (a copy); ``t``
    itself where ``dim`` is None."""
    if dim is None:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, index * size, size).clone()


def shard_state_dict(sd: dict, n: int, index: int, specs: dict) -> dict:
    """Shard ``index`` of a whole state dict (parameters, spectral
    ``weight_u`` / ``weight_v``, or per-parameter Adam moments keyed by
    parameter name) under ``specs`` (:func:`tp_specs`)."""
    return {k: shard_tensor(v, specs.get(k), n, index)
            if isinstance(v, torch.Tensor) else v for k, v in sd.items()}


def gather_state_dict(shards: Sequence[dict], specs: dict) -> dict:
    """The inverse of :func:`shard_state_dict`: the shards, in order, put
    back together (a key kept whole is taken from shard 0)."""
    first = shards[0]
    return {k: torch.cat([s[k] for s in shards], dim=specs[k])
            if specs.get(k) is not None else v for k, v in first.items()}


# ------------------------------------------------------------------ groups

class Shards:
    """What a split conv sums over: ``n`` shards, this one ``index``.
    ``pair_sums`` counts the sums after a row-parallel conv2 this shard took
    part in, ``sums`` every sum (spectral norm's and the backward's too),
    ``sum_s`` their host seconds; with ``timed`` the card is synchronized
    around each sum, so that its seconds are the sum's own."""

    n: int

    def __init__(self):
        self.pair_sums = 0
        self.sums = 0
        self.sum_s = 0.0
        self.timed = False

    @property
    def index(self) -> int:
        raise NotImplementedError

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_sum(self, t: torch.Tensor, pair: bool = False) -> torch.Tensor:
        """The sum of ``t`` over the shards, in float32 (a new tensor)."""
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = self._sum(t)
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        if self._counts():
            self.sums += 1
            self.pair_sums += int(pair)
            self.sum_s += time.perf_counter() - t0
        return out

    def _counts(self) -> bool:
        """Whether this shard counts the sum (one count a sum)."""
        return True

    def _gather(self, t: torch.Tensor, shapes) -> list:
        raise NotImplementedError

    def all_gather(self, t: torch.Tensor, shapes=None) -> list:
        """Every shard's ``t`` in shard order, exact (new tensors on ``t``'s
        device; shard j's of shape ``shapes[j]``, default ``t``'s).
        Counted and timed with the sums."""
        shapes = [tuple(t.shape)] * self.n if shapes is None else [
            tuple(sh) for sh in shapes]
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = self._gather(t.detach(), shapes)
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        if self._counts():
            self.sums += 1
            self.sum_s += time.perf_counter() - t0
        return out


class ProcessShards(Shards):
    """One shard a process: the ranks of this rank's model group."""

    def __init__(self, pg, ranks: Sequence[int], index: int):
        super().__init__()
        self.pg, self.ranks = pg, list(ranks)
        self.n = len(self.ranks)
        self._index = index

    @property
    def index(self) -> int:
        return self._index

    def _sum(self, t):
        y = t.detach().to(torch.float32, copy=True)
        torch.distributed.all_reduce(y, group=self.pg)
        return y

    def broadcast_(self, t: torch.Tensor, index: int) -> None:
        """Shard ``index``'s ``t`` into every shard's, in place (exact)."""
        torch.distributed.broadcast(t, self.ranks[index], group=self.pg)

    def _gather(self, t, shapes):
        # one broadcast from each shard: exact, and gloo carries CUDA
        # tensors for it
        out = []
        for j, shape in enumerate(shapes):
            buf = (t.contiguous().clone() if j == self._index
                   else t.new_empty(shape))
            self.broadcast_(buf, j)
            out.append(buf)
        return out


class ThreadShards(Shards):
    """``len(devices)`` shards in this process, each run in a thread of its
    own by :meth:`run`; the sums meet in host memory."""

    def __init__(self, devices: Sequence):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        self._local = threading.local()
        self._slots: List[Optional[torch.Tensor]] = [None] * self.n
        self._barrier: Optional[threading.Barrier] = None
        self._lock = threading.Lock()       # one run at a time

    @property
    def index(self) -> int:
        return self._local.index

    def _counts(self) -> bool:
        return self.index == 0

    def _wait(self):
        self._barrier.wait()

    def _sum(self, t):
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError("in-process tensor parallelism runs without "
                               "autograd; training takes one rank a "
                               "process (parallel/launch.py)")
        i = self.index
        self._slots[i] = t
        self._wait()
        acc = self._slots[0].to(t.device, torch.float32, copy=True)
        for j in range(1, self.n):
            acc += self._slots[j].to(t.device, torch.float32)
        self._wait()
        return acc

    def _gather(self, t, shapes):
        self._slots[self.index] = t
        self._wait()
        out = [self._slots[j].to(t.device, copy=True) for j in range(self.n)]
        self._wait()
        return out

    def run(self, fn: Callable[[int, torch.device], object]) -> list:
        """``fn(index, device)`` on every shard at once, shard 0 on the
        calling thread; the results in order.  The caller's inference or
        no-grad mode holds in every shard; a shard that raises releases
        the others and its error is raised here."""
        inference = torch.is_inference_mode_enabled()
        out: list = [None] * self.n
        errors: list = []

        def one(i):
            self._local.index = i
            dev = self.devices[i]
            try:
                with torch.inference_mode(inference), torch.no_grad():
                    if dev.type == "cuda":
                        with torch.cuda.device(dev):
                            out[i] = fn(i, dev)
                    else:
                        out[i] = fn(i, dev)
            except threading.BrokenBarrierError:
                pass
            except BaseException as e:      # noqa: BLE001 - re-raised below
                errors.append(e)
                self._barrier.abort()

        with self._lock:
            self._barrier = threading.Barrier(self.n)
            threads = [threading.Thread(target=one, args=(i,),
                                        name=f"wut-tp-shard{i}")
                       for i in range(1, self.n)]
            for th in threads:
                th.start()
            try:
                one(0)
            finally:
                for th in threads:
                    th.join()
                self._slots = [None] * self.n
        if errors:
            raise errors[0]
        return out


# ----------------------------------------------------------------- reduces

class _SumAfterRow(torch.autograd.Function):
    """After a row-parallel conv2: the sum over the shards forward, the
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return group.all_sum(x, pair=True)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


class _CopyBeforeColumn(torch.autograd.Function):
    """Before a column-parallel conv1: the identity forward, the sum over
    the shards backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_sum(g.contiguous()).to(g.dtype), None


class _SumBothWays(torch.autograd.Function):
    """Spectral norm's sigma: the sum forward and backward (each shard
    divides its own slice by sigma)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_sum(x.reshape(1)).reshape(()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_sum(g.reshape(1)).reshape(()).to(g.dtype), None


@dataclasses.dataclass
class Split:
    """How one conv of a split pair runs: ``kind`` "column" (conv1) or
    "row" (conv2), over ``group``."""

    kind: str
    group: Shards

    def inputs(self, *xs):
        """A column conv's replicated inputs, summed in the backward."""
        if self.kind != "column":
            return xs
        return tuple(None if x is None else
                     _CopyBeforeColumn.apply(x, self.group) for x in xs)

    def output(self, partial: torch.Tensor,
               bias: Optional[torch.Tensor]) -> torch.Tensor:
        """A row conv's bias-free partial output, summed over the shards in
        float32, plus ``bias``, rounded once to the partial's dtype."""
        if self.kind != "row":
            raise ValueError("only a row-parallel conv sums its output")
        z = _SumAfterRow.apply(partial, self.group)
        if bias is not None:
            z = z + bias.float().view(1, -1, 1, 1)
        return z.to(partial.dtype)

    def sigma(self, s: torch.Tensor) -> torch.Tensor:
        return _SumBothWays.apply(s, self.group)

    def vector_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.group.all_sum(t).to(t.dtype)

    def norm(self, t: torch.Tensor) -> torch.Tensor:
        """The 2-norm of the vector whose shard ``t`` is."""
        return self.group.all_sum(t.square().sum().reshape(1)).reshape(
            ()).sqrt().to(t.dtype)


@dataclasses.dataclass
class Layout:
    """A module split in place by :func:`shard_`: its whole state dict's
    ``specs``, and this shard ``index`` of ``n`` over ``group``."""

    specs: dict
    n: int
    index: int
    group: Shards


def layout_of(module: torch.nn.Module) -> Optional[Layout]:
    return getattr(module, "tp_layout", None)


def shard_(module: torch.nn.Module, group: Shards,
           specs: Optional[dict] = None,
           index: Optional[int] = None) -> torch.nn.Module:
    """Split ``module`` in place: each split pair's tensors become shard
    ``index``'s (default: the group's own; ``p.data`` swapped, so an
    optimizer made before keeps its parameters, and must hold no state
    yet) and its convs run through ``group``.  ``specs`` defaults to
    :func:`tp_specs` at the group's degree; a module that splits nothing
    is refused."""
    n = group.n
    index = group.index if index is None else index
    if getattr(module, "fuse_levels", ()):
        raise ValueError(
            "fuse_upconv serving is single-device; rebuild the model "
            "with fuse_upconv=False when passing a MeshPlan")
    if layout_of(module) is not None:
        raise ValueError("the module is split already")
    if specs is None:
        specs = tp_specs(module, n)
        require_split([specs], n)
    tensors = module.state_dict(keep_vars=True)
    with torch.no_grad():
        for key, dim in specs.items():
            if dim is not None:
                t = tensors[key]
                t.data = shard_tensor(t.data, dim, n, index)
    for p, a, b in split_pairs(module, n):
        conv1, conv2 = _member(module, p, a), _member(module, p, b)
        conv1.tp = Split("column", group)
        conv2.tp = Split("row", group)
        if isinstance(conv1, torch.nn.Conv2d):
            conv1.out_channels //= n
            conv2.in_channels //= n
    module.tp_layout = Layout(specs, n, index, group)
    return module


def weight_bytes(module: torch.nn.Module) -> int:
    """Bytes of the module's parameters as this process holds them."""
    return sum(p.numel() * p.element_size() for p in module.parameters())


# --------------------------------------------------- whole state <-> shard

def _param_names(optimizer, module) -> list:
    """The optimizer state dict's parameter indices' names."""
    names = {id(p): n for n, p in module.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def _gather(t: torch.Tensor, dim: int, lay: Layout) -> torch.Tensor:
    """The whole tensor of which every shard holds ``t``'s slice along
    ``dim``: each slice broadcast from its owner (exact, and gloo carries
    CUDA tensors for it)."""
    g = lay.group
    if not isinstance(g, ProcessShards):
        raise ValueError("a split module's whole state is gathered over "
                         "a process group")
    parts = []
    for j in range(lay.n):
        buf = t.detach().clone() if j == lay.index else torch.empty_like(t)
        g.broadcast_(buf, j)
        parts.append(buf)
    return torch.cat(parts, dim=dim)


def full_state_dict(module: torch.nn.Module) -> dict:
    """``module.state_dict()`` of the whole model: gathered over the model
    group where ``module`` is split (every shard must call it), as it is
    otherwise."""
    sd = module.state_dict()
    lay = layout_of(module)
    if lay is None:
        return sd
    return {k: _gather(v, lay.specs[k], lay)
            if lay.specs.get(k) is not None else v for k, v in sd.items()}


def load_full_state_dict(module: torch.nn.Module, sd: dict) -> None:
    """Load a whole model's state dict, strictly: this shard's slice of it
    where ``module`` is split."""
    lay = layout_of(module)
    if lay is not None:
        sd = shard_state_dict(sd, lay.n, lay.index, lay.specs)
    module.load_state_dict(sd, strict=True)


def _moments(st: dict, shape) -> list:
    return [k for k, v in st.items()
            if isinstance(v, torch.Tensor) and v.shape == shape]


def full_optimizer_state_dict(optimizer, module) -> dict:
    """``optimizer.state_dict()`` with each split parameter's moments whole
    (every shard must call it where ``module`` is split)."""
    sd = optimizer.state_dict()
    lay = layout_of(module)
    if lay is None:
        return sd
    params = dict(module.named_parameters())
    names = _param_names(optimizer, module)
    state = {}
    for i, st in sd["state"].items():
        dim = lay.specs.get(names[i])
        keys = (_moments(st, params[names[i]].shape) if dim is not None
                else [])
        state[i] = {k: _gather(v, dim, lay) if k in keys else v
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state_dict(optimizer, module, sd: dict) -> None:
    """Load a whole model's optimizer state dict: this shard's slice of each
    split parameter's moments where ``module`` is split."""
    lay = layout_of(module)
    if lay is not None:
        names = _param_names(optimizer, module)
        state = {}
        for i, st in sd["state"].items():
            dim = lay.specs.get(names[i])
            state[i] = {k: shard_tensor(v, dim, lay.n, lay.index)
                        if isinstance(v, torch.Tensor) and v.dim() > 0
                        else v for k, v in st.items()}
        sd = {"state": state, "param_groups": sd["param_groups"]}
    optimizer.load_state_dict(sd)


def full_param_states(optimizer, module) -> dict:
    """The optimizer's per-parameter states by parameter name, whole
    (``compat/torch_io.py::adam_state_to_jax`` reads them)."""
    sd = full_optimizer_state_dict(optimizer, module)
    names = _param_names(optimizer, module)
    return {names[i]: st for i, st in sd["state"].items()}


def shard_param_states(by_name: dict, module) -> dict:
    """Per-parameter states of the whole model by name -> this shard's."""
    lay = layout_of(module)
    if lay is None:
        return by_name
    return {n: {k: shard_tensor(v, lay.specs.get(n), lay.n, lay.index)
                if isinstance(v, torch.Tensor) and v.dim() > 0 else v
                for k, v in st.items()} for n, st in by_name.items()}


# ----------------------------------------------------------------- helpers

def shard_gan_(gen, disc, group: Shards) -> None:
    """Split both GAN networks over ``group``; the degree is refused only
    when it splits no key of either (``tp_shardings`` over the whole
    state)."""
    specs = [tp_specs(gen, group.n), tp_specs(disc, group.n)]
    require_split(specs, group.n)
    shard_(gen, group, specs[0])
    shard_(disc, group, specs[1])


def process_shards() -> ProcessShards:
    """This rank's model group (``mesh.make_mesh`` made it) as a
    :class:`ProcessShards`."""
    from weather_unet_tpu_torch.parallel import launch, mesh

    pg, ranks = mesh.model_group()
    return ProcessShards(pg, ranks, launch.model_index())


def describe(n: int, num_classes: int = 5) -> dict:
    """What ``n``-way tensor parallelism does to the cUNet and the SNDisc
    at their full widths: the split pairs and the weight bytes of the
    whole network and of one shard (parameters, float32)."""
    from weather_unet_tpu_torch.models import ConditionalUNet, SNDisc

    out = {"model_axis": n}
    with torch.device("meta"):
        nets = {"cUNet": ConditionalUNet(num_classes),
                "SNDisc": SNDisc(num_classes)}
    for name, net in nets.items():
        specs = tp_specs(net, n)
        params = dict(net.named_parameters())
        whole = sum(p.numel() * 4 for p in params.values())
        shard = sum(p.numel() * 4 // (n if specs[k] is not None else 1)
                    for k, p in params.items())
        out[name] = {"split_pairs": [p for p, _, _ in split_pairs(net, n)],
                     "weight_bytes": whole, "shard_weight_bytes": shard}
    return out
