"""The AOT tier: one program per input shape, captured as a CUDA graph on
the card -- the port of ``weather_unet_tpu/core/aot.py``.

The JAX module keeps one compiled XLA executable per input shape and
serializes it to disk, so a restarted process loads it instead of
compiling for minutes.  PyTorch runs eagerly: there is no compile for a
disk entry to skip (an exported program replays the same aten ops and
would be captured anew all the same), so the port keeps the in-memory half
only:

* **one program per shape** (``AotJit``): on a CUDA device the program's
  whole work for that shape -- a serving forward, or a whole training step
  with its backward and optimizer update -- is captured once as a CUDA
  graph and replayed with one launch per call.  The dynamic inputs are
  copied into the graph's static buffers; the arguments named in
  ``inplace_argnums`` (a train state) are read and written where they lie,
  so they must be the same tensors at every call (checked; a restore that
  replaces them instead of copying into them needs ``AotJit.reset()``).
  Tensors the program reaches by closure (a model's weights) are read
  where they lie too: a ``load_state_dict`` copies into them, so a graph
  sees new weights.  Before a capture the program runs once on a side
  stream, so every host-side cache (kernel plans, tap tables, packed
  weights, optimizer state) is built outside the graph; the in-place state
  is put back as it was afterwards, so the first call computes what an
  eager call would.  Explicit ``torch.Generator`` arguments are registered
  with the graph: each replay draws from the generator's current seed and
  offset.  A capture that fails raises; nothing falls back to eager
  execution.
* **nothing on disk**: a CUDA graph cannot outlive its process, so a
  restart captures each shape again (``PERF.md`` §6 gives a server's
  start-up with and without the tier).  ``AotCache`` takes a directory
  because ``aot_cache=`` / ``--aot_cache`` are the JAX package's arguments,
  and writes nothing there; it holds the capture counters and the side
  stream, and runs one capture at a time.

On the CPU there is no graph: each shape's program is the function itself,
so the tier equals eager execution bit for bit there.  A program made with
``capture=False`` takes that form on the card too (a tensor-parallel
serving forward, whose shards meet in host memory between their launches).

``stats`` keys: ``programs`` (shapes seen), ``captures`` (CUDA graphs),
``capture_s``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Sequence

import torch
import torch.nn as nn

# side-stream runs before a capture: one builds every host-side cache (the
# capture check of chip_smoke.py holds that none is built during a capture)
WARMUP_CALLS = 1


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


def _device_of(args) -> torch.device:
    devs = {t.device for t in _tensors(args)}
    if len(devs) != 1:
        raise ValueError(f"an AOT program's tensors must lie on one device, "
                         f"got {sorted(map(str, devs))}")
    return devs.pop()


# ------------------------------------------------------------ CUDA graphs
class _Graphed:
    """One captured CUDA graph of ``fn`` at one input shape; calling it
    copies the dynamic inputs into the static buffers, replays, and returns
    copies of the outputs (the next replay overwrites the static ones).
    ``stream`` is the side stream of its warm-up and its capture."""

    def __init__(self, fn: Callable, args: tuple, inplace: Sequence[int],
                 stream: torch.cuda.Stream):
        self.inplace = tuple(sorted(set(inplace)))
        self._roots = frozenset(map(str, self.inplace))
        dev = _device_of(args)
        self.static = tuple(
            a if i in self.inplace else _tree_map(torch.clone, a)
            for i, a in enumerate(args))
        held, self.generators = self._held(self.static)
        self._warm_up(fn, dev, held, stream)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        # captured on a side stream as torch.cuda.graph captures, without
        # the device synchronize and the emptied caching allocator it does
        # first: a server's start would pay both at every bucket
        current = torch.cuda.current_stream(dev)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.out = fn(*self.static)
            finally:
                self.graph.capture_end()
        current.wait_stream(stream)
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

    def _warm_up(self, fn: Callable, dev: torch.device, held: dict,
                 side: torch.cuda.Stream) -> None:
        """Run ``fn`` on a side stream, then put the in-place state and the
        generators back as they were.  Tensors the runs created (an
        optimizer's first moments and step count) are zeroed, their value
        before a first step; a tensor the runs replaced instead of updating
        in place raises, since a graph would not see the replacement."""
        saved = {p: (t, t.clone()) for p, t in held.items()}
        gen_states = [g.get_state() for g in self.generators]
        current = torch.cuda.current_stream(dev)
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
    """The tier's shared state: the capture counters and one side stream
    per device (module docstring).

    >>> cache = AotCache("/var/cache/wut_aot")
    >>> fwd = cache.load_or_compile(fn, x, c)   # a CUDA graph on the card
    >>> out = fwd(x, c)

    ``load_or_compile`` returns a callable with ``fn``'s signature: on a
    CUDA device a captured graph, on the CPU the program itself.  Nothing
    is written to the directory.  Thread-safe: the ``AotJit``s of one cache
    (a ``WeatherTransfer``'s three entry points) capture one at a time.
    """

    def __init__(self, cache_dir: str):
        del cache_dir   # the JAX package's argument; nothing is kept there
        self.stats = {"programs": 0, "captures": 0, "capture_s": 0.0}
        # one side stream per device for every warm-up and capture, as
        # torch.cuda.graph keeps one capture stream: a new stream each time
        # makes the CUDA libraries set up their per-stream state again
        self._streams: dict = {}
        # held over a warm-up and its capture: in "thread_local" mode work
        # that a second thread queued on the stream under capture would
        # join the graph.  Reentrant, so a program that calls another
        # entry point of the cache fails its capture instead of hanging.
        self._lock = threading.RLock()

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def load_or_compile(self, fn: Callable, *args: Any,
                        inplace_argnums: Sequence[int] = (),
                        capture: bool = True) -> Callable:
        """The program of ``fn`` at ``args``' shapes (values do not matter):
        on a CUDA device its CUDA graph, captured now, unless ``capture``
        is False (then ``fn`` itself, as on the CPU); ``inplace_argnums``
        are the arguments whose tensors the graph reads and writes where
        they lie."""
        device = _device_of(args)
        with self._lock:
            self.stats["programs"] += 1
            if device.type != "cuda" or not capture:
                return fn
            t0 = time.perf_counter()
            exe = _Graphed(fn, args, inplace_argnums, self._stream(device))
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
            return exe


class AotJit:
    """One program per input shape through an :class:`AotCache`: the
    port's counterpart of ``jax.jit`` with the AOT tier (module docstring).

    ``inplace_argnums``: arguments read and written where they lie (a
    train state); the others are the dynamic inputs, whose shapes, dtypes
    and devices key the programs.  An in-place argument is the same object
    at every call (a graph checks its tensors), and its own shapes change
    under the program (an optimizer's first step creates its moments), so
    it is not part of the key.  Thread-safe: a graph's static buffers serve
    one call at a time, and the cache takes one capture at a time.  ``_cache_size`` is the number of shapes, as
    ``jax.jit``'s is.  ``capture=False``: every program is ``fn`` itself
    (``AotCache.load_or_compile``).
    """

    def __init__(self, fn: Callable, cache: AotCache, *,
                 inplace_argnums: Sequence[int] = (), capture: bool = True):
        self._fn = fn
        self._cache = cache
        self._inplace = tuple(inplace_argnums)
        self._capture = capture
        self._exes: dict = {}
        self._lock = threading.Lock()

    def __call__(self, *args):
        with self._lock:
            key = tuple(_leaf_key(a) for i, a in enumerate(args)
                        if i not in self._inplace)
            exe = self._exes.get(key)
            if exe is None:
                exe = self._cache.load_or_compile(
                    self._fn, *args, inplace_argnums=self._inplace,
                    capture=self._capture)
                self._exes[key] = exe
            return exe(*args)

    def reset(self) -> None:
        """Drop every program (and its graph): the next call at each shape
        captures again.  Needed after a restore that replaced tensors of an
        in-place argument."""
        with self._lock:
            self._exes.clear()

    def _cache_size(self) -> int:
        return len(self._exes)
