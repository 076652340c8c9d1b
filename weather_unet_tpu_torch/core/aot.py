"""The AOT tier: one program per input shape, a CUDA graph of it on the card,
and a disk tier of exported serving programs -- the port of
``weather_unet_tpu/core/aot.py``.

The JAX module keeps one compiled XLA executable per input shape and
serializes it to disk, so a restarted process loads it instead of
compiling.  Here the parts map like this:

* **one program per shape, in memory** (``AotJit``): on a CUDA device the
  program's whole work for that shape -- a serving forward, or a whole
  training step with its backward and optimizer update -- is captured once
  as a CUDA graph and replayed with one launch per call.  The dynamic
  inputs are copied into the graph's static buffers; the arguments named
  in ``inplace_argnums`` (weights, a train state) are read and written
  where they lie, so they must be the same tensors at every call (checked;
  a restore that replaces them instead of copying into them needs
  ``AotJit.reset()``).  Before a capture the program runs a few times on a
  side stream, so every host-side cache (kernel plans, tap tables, packed
  weights, optimizer state) is built outside the graph; the state is put
  back as it was afterwards, so the first call computes what an eager call
  would.  Explicit ``torch.Generator`` arguments are registered with the
  graph: each replay draws from the generator's current seed and offset.
  A capture that fails raises; nothing falls back to eager execution.
* **the disk tier** (``AotCache``), for programs exported with
  ``disk=True`` (the serving forwards): ``torch.export`` of the function
  with the weights as *inputs* (a functional wrapper over
  ``torch.func.functional_call``), saved with ``torch.export.save``.  The
  blob holds no weights, so one entry serves every checkpoint of one
  architecture.  K1, K2 and K3 stay in it as the registered ops
  ``wut::adain``, ``wut::upsample2x`` and ``wut::upconv``.  A blob that
  fails to load or to run is deleted and exported afresh, counted in
  ``stats["fallbacks"]``: the tier's documented miss path.
* **training steps have no disk tier**: a CUDA graph cannot outlive its
  process, and an eager step has no compile for a disk entry to skip.
  Their programs are captured per process and counted in
  ``stats["captures"]``.

The key of a disk entry is the SHA-256 of the backend fingerprint (torch
and CUDA versions, the card's name and compute capability, the device
count, a digest of ``csrc/``; on the CPU the host fingerprint of
``core/profiling.py``), a digest of the package's Python sources, the
program's name and flags (``use_pallas``, ``fuse_upconv``, the dtype and
the architecture) and every input's name, shape and dtype.  JAX hashes
the lowered program, which it builds before every compile anyway; the
export is the whole cost a disk hit saves here, so the key hashes what the
exported graph is made from instead, and a change to any of it misses
cleanly.  Entries live in a subdirectory of the root named by the
fingerprint, with a ``HOST.json`` manifest.

On the CPU the disk tier and the per-shape programs work as on the card,
without a graph: there is none on a CPU.

``stats`` keys: ``hits``, ``misses``, ``load_s``, ``compile_s`` (export
plus capture seconds), ``fallbacks``, ``captures``.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.nn as nn

from weather_unet_tpu_torch.core import profiling

_PKG = Path(__file__).resolve().parent.parent
ENTRY_SUFFIX = ".pt2"
WARMUP_CALLS = 3     # side-stream runs before a capture (PyTorch's advice)


def default_cache_dir() -> str:
    """The one default root of the port's AOT tier (the CLIs take any
    directory; ``cli/doctor.py`` reports this one)."""
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "weather_unet_tpu_torch_aot")


@functools.cache
def _digest(pattern: str) -> str:
    """SHA-256 over the package files matching ``pattern`` (names and
    bytes, in sorted order)."""
    h = hashlib.sha256()
    for path in sorted(_PKG.glob(pattern)):
        h.update(str(path.relative_to(_PKG)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _backend_fingerprint(device: torch.device) -> str:
    parts = [torch.__version__, str(torch.version.cuda), device.type]
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        major, minor = torch.cuda.get_device_capability(index)
        parts += [torch.cuda.get_device_name(index), f"sm_{major}{minor}",
                  str(torch.cuda.device_count())]
    else:
        parts.append(profiling._host_fingerprint())
    parts.append(_digest("csrc/*"))
    return "|".join(parts)


def fingerprint_dir_name(device) -> str:
    """The name of ``device``'s subdirectory under an AOT root: 12 hex
    digits of the backend fingerprint's SHA-256."""
    fp = _backend_fingerprint(torch.device(device))
    return hashlib.sha256(fp.encode()).hexdigest()[:12]


# ---------------------------------------------------------------- pytrees
def _walk(obj, visit, path="") -> None:
    """Visit every leaf of an argument in a fixed order with its path:
    tensors; dicts, lists and tuples; a module's parameters and buffers; an
    optimizer's state tensors; a dataclass's fields; anything else is a
    leaf itself."""
    if isinstance(obj, torch.Tensor):
        visit(path, obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, visit, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _walk(v, visit, f"{path}/{i}")
    elif isinstance(obj, nn.Module):
        for k, v in obj.named_parameters():
            visit(f"{path}/{k}", v)
        for k, v in obj.named_buffers():
            visit(f"{path}/{k}", v)
    elif isinstance(obj, torch.optim.Optimizer):
        for g, group in enumerate(obj.param_groups):
            for i, p in enumerate(group["params"]):
                state = obj.state.get(p, {})
                for k in sorted(state):
                    _walk(state[k], visit, f"{path}/{g}/{i}/{k}")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _walk(getattr(obj, f.name), visit, f"{path}/{f.name}")
    else:
        visit(path, obj)


def _leaves(obj) -> list:
    out = []
    _walk(obj, lambda _, leaf: out.append(leaf))
    return out


def _tensors(obj) -> list:
    return [t for t in _leaves(obj) if isinstance(t, torch.Tensor)]


def _tree_map(fn, obj):
    """``fn`` over the tensors of nested dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    return obj


def _leaf_key(obj) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device.type)
                 if isinstance(t, torch.Tensor) else type(t).__name__
                 for t in _leaves(obj))


def _describe(args) -> str:
    """Every input's path, shape and dtype (a disk key's input specs)."""
    out = []

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor):
            out.append(f"{path}:{tuple(leaf.shape)}:{leaf.dtype}")
        else:
            out.append(f"{path}:{type(leaf).__name__}")

    for i, a in enumerate(args):
        _walk(a, visit, str(i))
    return "\n".join(out)


def _device_of(args) -> torch.device:
    devs = {t.device for t in _tensors(args)}
    if len(devs) != 1:
        raise ValueError(f"an AOT program's tensors must lie on one device, "
                         f"got {sorted(map(str, devs))}")
    return devs.pop()


def module_signature(model: nn.Module) -> str:
    """What a disk entry of a forward of ``model`` depends on beyond its
    input specs: the flags that select its kernels and dtype, and its
    architecture."""
    flags = {k: str(getattr(model, k)) for k in
             ("use_pallas", "fuse_levels", "dtype", "num_classes")
             if hasattr(model, k)}
    return f"{json.dumps(flags, sort_keys=True)}\n{model!r}"


class _AsModule(nn.Module):
    """A function as the module ``torch.export`` takes.  The function is
    not a submodule: whatever module it closes over is traced through, and
    its weights come in as inputs."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


# ------------------------------------------------------------ CUDA graphs
class _Graphed:
    """One captured CUDA graph of ``fn`` at one input shape; calling it
    copies the dynamic inputs into the static buffers, replays, and returns
    copies of the outputs (the next replay overwrites the static ones)."""

    def __init__(self, fn: Callable, args: tuple, inplace: Sequence[int]):
        self.inplace = tuple(sorted(set(inplace)))
        self._roots = frozenset(map(str, self.inplace))
        dev = _device_of(args)
        self.static = tuple(
            a if i in self.inplace else _tree_map(torch.clone, a)
            for i, a in enumerate(args))
        held, self.generators = self._held(self.static)
        self._warm_up(fn, dev, held)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = fn(*self.static)
        # path -> address of every in-place tensor the graph could read or
        # write: the ones that existed when it was captured.  Tensors made
        # later (another program's first optimizer update) are not in it.
        self.ptrs = {p: t.data_ptr()
                     for p, t in self._held(self.static)[0].items()}

    def _held(self, args) -> tuple:
        """The in-place arguments' tensors by path, and the generators of
        all the arguments, in one walk."""
        tensors, gens = {}, []

        def visit(path, leaf):
            if isinstance(leaf, torch.Generator):
                gens.append(leaf)
            elif (isinstance(leaf, torch.Tensor)
                  and path.split("/")[0] in self._roots):
                tensors[path] = leaf

        for i, a in enumerate(args):
            _walk(a, visit, str(i))
        return tensors, gens

    def _warm_up(self, fn: Callable, dev: torch.device, held: dict) -> None:
        """Run ``fn`` on a side stream, then put the in-place state and the
        generators back as they were.  Tensors the runs created (an
        optimizer's first moments and step count) are zeroed, their value
        before a first step; a tensor the runs replaced instead of updating
        in place raises, since a graph would not see the replacement."""
        saved = {p: (t, t.clone()) for p, t in held.items()}
        gen_states = [g.get_state() for g in self.generators]
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                fn(*self.static)
        current.wait_stream(side)
        after = self._held(self.static)[0]
        gone = [p for p, (t, _) in saved.items() if after.get(p) is not t]
        if gone:
            raise RuntimeError(
                f"the program replaced {len(gone)} tensor(s) of its in-place "
                f"arguments ({gone[:3]}) instead of updating them in place; "
                "a CUDA graph would keep writing the old ones")
        with torch.no_grad():
            for p, t in after.items():
                old = saved.get(p)
                if old is None:
                    t.zero_()
                else:
                    t.copy_(old[1])
        for g, s in zip(self.generators, gen_states):
            g.set_state(s)

    def __call__(self, *args):
        held, gens = self._held(args)
        if any(p not in held or held[p].data_ptr() != ptr
               for p, ptr in self.ptrs.items()):
            raise RuntimeError(
                "the in-place arguments' tensors are not the ones this CUDA "
                "graph was captured on (replaced by a restore?); call "
                "reset() on the AotJit to capture again")
        if len(gens) != len(self.generators) or any(
                a is not b for a, b in zip(gens, self.generators)):
            raise RuntimeError("a CUDA graph draws from the generators it "
                               "was captured with; pass the same ones")
        for i, a in enumerate(args):
            if i in self.inplace:
                continue
            for src, dst in zip(_tensors(a), _tensors(self.static[i])):
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
        self.graph.replay()
        return _tree_map(torch.clone, self.out)


# ------------------------------------------------------------- the cache
class AotCache:
    """The disk tier and the capture counter (module docstring).

    >>> cache = AotCache("/var/cache/wut_aot")
    >>> fwd = cache.load_or_compile(fn, weights, x, c)   # export once
    >>> out = fwd(weights, x, c)      # later processes: load, no export

    ``load_or_compile`` returns a callable with ``fn``'s signature: on a
    CUDA device a captured graph, on the CPU the program itself.  Entries
    go to ``<cache_dir>/<fingerprint>/<key>.pt2``.
    """

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        self.stats = {"hits": 0, "misses": 0, "load_s": 0.0,
                      "compile_s": 0.0, "fallbacks": 0, "captures": 0}
        self._subdirs: dict = {}

    # -- layout -----------------------------------------------------------
    def dir_for(self, device) -> str:
        """The fingerprint subdirectory of ``device``'s entries, created
        with its ``HOST.json`` manifest (and the root pruned) on first
        use."""
        device = torch.device(device)
        sub = self._subdirs.get(device.type)
        if sub is None:
            name = fingerprint_dir_name(device)
            sub = os.path.join(self.dir, name)
            manifest = os.path.join(sub, "HOST.json")
            if not os.path.isfile(manifest):
                os.makedirs(sub, exist_ok=True)
                with open(manifest, "w") as f:
                    json.dump({"fingerprint": name,
                               "backend": _backend_fingerprint(device),
                               **profiling._host_basis()}, f, indent=1)
                profiling._prune_stale_cache(self.dir, keep=name)
            self._subdirs[device.type] = sub
        return sub

    def _key(self, device: torch.device, program: str, args) -> str:
        h = hashlib.sha256()
        h.update(_backend_fingerprint(device).encode())
        h.update(_digest("**/*.py").encode())
        h.update(program.encode())
        h.update(_describe(args).encode())
        return h.hexdigest()[:32]

    # -- main entry ---------------------------------------------------------
    def load_or_compile(self, fn: Callable, *args: Any,
                        program: Optional[str] = None,
                        inplace_argnums: Sequence[int] = (),
                        disk: bool = True) -> Callable:
        """The program of ``fn`` at ``args``' shapes (values do not matter).

        ``disk``: go through the disk tier (``fn`` must be exportable, its
        weights among ``args``); ``program`` names what the exported graph
        is built from besides the input specs (``module_signature``).
        ``inplace_argnums``: arguments whose tensors a graph reads and
        writes where they lie."""
        device = _device_of(args)
        exe = fn
        if disk:
            name = program or f"{fn.__module__}.{fn.__qualname__}"
            path = os.path.join(self.dir_for(device),
                                self._key(device, name, args) + ENTRY_SUFFIX)
            exe = self._try_load(path, args)
            if exe is not None:
                self.stats["hits"] += 1
            else:
                self.stats["misses"] += 1
                t0 = time.perf_counter()
                exported = self._export(fn, args)
                self.stats["compile_s"] += time.perf_counter() - t0
                self._try_save(path, exported)
                exe = exported.module()
        if device.type == "cuda":
            t0 = time.perf_counter()
            exe = _Graphed(exe, args, inplace_argnums)
            self.stats["captures"] += 1
            self.stats["compile_s"] += time.perf_counter() - t0
        return exe

    @staticmethod
    def _export(fn: Callable, args):
        """``torch.export`` of ``fn`` at ``args`` (plain copies of them, so
        that inference tensors and parameters trace alike)."""
        with torch.inference_mode(False), torch.no_grad():
            example = tuple(_tree_map(lambda t: t.detach().clone(), a)
                            for a in args)
            return torch.export.export(_AsModule(fn), example, strict=False)

    @staticmethod
    def _validate(exe: Callable, args) -> bool:
        """Run a loaded program once on zeros of ``args``' shapes: a blob
        that loads but cannot run fails here, not in a caller's request."""
        try:
            with torch.no_grad():
                exe(*(_tree_map(torch.zeros_like, a) for a in args))
            return True
        except Exception:
            return False

    def _drop(self, path: str) -> None:
        self.stats["fallbacks"] += 1
        try:
            os.unlink(path)
        except OSError:
            pass

    # -- serialization -------------------------------------------------------
    def _try_load(self, path: str, args) -> Optional[Callable]:
        if not os.path.exists(path):
            return None
        # the programs call wut::adain, wut::upsample2x, wut::upconv
        from weather_unet_tpu_torch.kernels import (  # noqa: F401
            adain, upconv, upsample)

        t0 = time.perf_counter()
        try:
            exe = torch.export.load(path).module()
        except Exception:
            # a partial write, another format, a missing op: export afresh
            self._drop(path)
            return None
        if not self._validate(exe, args):
            self._drop(path)
            return None
        self.stats["load_s"] += time.perf_counter() - t0
        return exe

    def _try_save(self, path: str, exported) -> bool:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-",
                                   suffix=ENTRY_SUFFIX)
        os.close(fd)
        try:
            torch.export.save(exported, tmp)
            os.replace(tmp, path)   # atomic: readers never see partials
        except Exception:
            self.stats["fallbacks"] += 1
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True


class AotJit:
    """One program per input shape through an :class:`AotCache`: the
    port's counterpart of ``jax.jit`` with the AOT tier (module docstring).

    ``disk``: exported programs through the disk tier (serving forwards);
    without it the function itself is the program (training steps).
    ``inplace_argnums``: arguments read and written where they lie (weights,
    a train state); the others are the dynamic inputs.  Thread-safe: a
    graph's static buffers serve one call at a time.  ``_cache_size`` is the
    number of shapes, as ``jax.jit``'s is.
    """

    def __init__(self, fn: Callable, cache: AotCache, *,
                 program: Optional[str] = None,
                 inplace_argnums: Sequence[int] = (), disk: bool = True):
        self._fn = fn
        self._cache = cache
        self._program = program
        self._inplace = tuple(inplace_argnums)
        self._disk = disk
        self._exes: dict = {}
        self._lock = threading.Lock()
        # id -> (container, fragment): identity-keyed memo of the shape key
        # of dict and in-place arguments, which serving and the trainers
        # pass as the same object on every call (walking their hundreds of
        # tensors per call would be waste).  The strong reference pins the
        # id; FIFO eviction bounds the memo for a caller cycling through
        # many containers.  A container whose tensors are replaced needs
        # reset() (the graph's own check raises first).
        self._frag: dict = {}
        self._frag_max = 64

    def _shape_key(self, args) -> tuple:
        frags = []
        for i, a in enumerate(args):
            if isinstance(a, dict) or i in self._inplace:
                ent = self._frag.get(id(a))
                if ent is None or ent[0] is not a:
                    ent = (a, _leaf_key(a))
                    if len(self._frag) >= self._frag_max:
                        self._frag.pop(next(iter(self._frag)))
                    self._frag[id(a)] = ent
                frags.append(ent[1])
            else:
                frags.append(_leaf_key(a))
        return tuple(frags)

    def __call__(self, *args):
        with self._lock:
            key = self._shape_key(args)
            exe = self._exes.get(key)
            if exe is None:
                exe = self._cache.load_or_compile(
                    self._fn, *args, program=self._program,
                    inplace_argnums=self._inplace, disk=self._disk)
                self._exes[key] = exe
            return exe(*args)

    def reset(self) -> None:
        """Drop every program (and its graph): the next call at each shape
        captures again.  Needed after a restore that replaced tensors of an
        in-place argument."""
        with self._lock:
            self._exes.clear()
            self._frag.clear()

    def _cache_size(self) -> int:
        return len(self._exes)


class BoundFn:
    """Bind leading arguments (the model's weights) to an :class:`AotJit`
    while keeping the ``_cache_size`` surface serving code and tests read."""

    def __init__(self, fn: Callable, *bound: Any):
        self._fn = fn
        self._bound = bound

    def __call__(self, *args):
        return self._fn(*self._bound, *args)

    def _cache_size(self) -> int:
        return self._fn._cache_size()
