"""Checkpoint save/restore with auto-resume -- the port of
``weather_unet_tpu/train/checkpoint.py``, in a torch-native format.

As in the JAX package (SURVEY.md §5): GAN runs save every 1000 steps under
``save_dir/name`` and auto-resume from the newest file
(``t_est_train.py:151-163,365-373``); unlike the reference, the optimizer
state is saved too, so a resume is exact.  One file per save,
``ckpt_s{step:010d}.pt`` (``torch.save`` of a dict of tensors and numbers,
loaded with ``weights_only=True``), written under a unique temporary name
and renamed into place; the newest step wins.  ``export_torch_gan`` writes
the reference's ``.pt`` GAN bundle; ``supervised_tree`` /
``restore_supervised`` hold the supervised loop's state.

The JAX package's checkpoints are flax msgpack files,
``ckpt_s{step:010d}.msgpack``; ``msgpack_restore`` / ``read_msgpack`` read
them and ``to_bytes`` / ``save_checkpoint_file`` write the same bytes as
flax, with ``msgpack`` alone (no flax, no JAX).  ``latest_checkpoint``
finds both kinds, so a port trainer pointed at a JAX run's ``save_dir``
resumes it: ``restore_checkpoint`` / ``restore_supervised`` load the JAX
package's ``GanTrainState`` and supervised layouts (weights, optax's Adam
state, the ``spectral`` collection, the counters) through
``compat/torch_io.py``.  ``gan_tree_to_jax`` / ``supervised_tree_to_jax``
are the inverses; the port's trainers keep writing ``.pt``.
"""

from __future__ import annotations

import io
import os
import re
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from weather_unet_tpu_torch.compat.torch_io import (
    adam_state_from_jax, adam_state_to_jax, cunet_state_dict_from_jax,
    cunet_state_dict_to_jax, resnet_state_dict_from_jax,
    resnet_state_dict_to_jax, sndisc_state_dict_from_jax,
    sndisc_state_dict_to_jax)
from weather_unet_tpu_torch.core.state import GanTrainState, TrainState
from weather_unet_tpu_torch.parallel import tp
from weather_unet_tpu_torch.parallel.launch import process_index

_CKPT_RE = re.compile(r"ckpt_s(\d+)\.(pt|msgpack)$")


def _to_host(tree):
    """A copy of ``tree`` with every tensor copied to host memory (a CPU
    tensor is copied too: the optimizers update their tensors in place)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def checkpoint_path(directory: str, name: str, step: int) -> str:
    return os.path.join(directory, name, f"ckpt_s{step:010d}.pt")


def serialize(host_tree: Any) -> bytes:
    """``torch.save``'s bytes for a host tree, a function of the tree
    alone: saved to a path, the zip's record names would carry the file's
    name, which differs between the staging names of two writers."""
    buf = io.BytesIO()
    torch.save(host_tree, buf)
    return buf.getvalue()


def _write(path: str, host_tree: Any) -> str:
    """Write a host tree to ``path`` through a unique temporary file.  Under
    a process group every rank writes the same bytes to the same path (the
    states are equal), newest wins; the staging name carries the rank, the
    pid and a random token, so two writers never share one."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = (f"{path}.tmp.r{process_index()}.{os.getpid()}."
           f"{uuid.uuid4().hex[:8]}")
    with open(tmp, "wb") as f:
        f.write(serialize(host_tree))
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str, name: str) -> Optional[str]:
    """Path of the newest checkpoint under ``directory/name`` -- the port's
    ``.pt`` or the JAX package's ``.msgpack`` -- by the step in its name;
    at one step the ``.pt`` wins.  None when there is none."""
    out_dir = os.path.join(directory, name)
    if not os.path.isdir(out_dir):
        return None
    cands = [(int(m.group(1)), m.group(2) == "pt", f)
             for f in os.listdir(out_dir) if (m := _CKPT_RE.match(f))]
    return os.path.join(out_dir, max(cands)[2]) if cands else None


def gan_tree(state: GanTrainState, seed: int) -> dict:
    """What a GAN checkpoint holds: both networks' state dicts (D's with its
    spectral-norm ``weight_u`` / ``weight_v`` buffers), both Adam states,
    the update counts, the epoch, the global step and the trainer's seed.
    The tensors are the live ones; saving copies them.  Where the networks
    are split (``parallel/tp.py``) the tree is the whole model's, gathered
    over the model group: every rank of the group must call this, and
    each gets the tree an unsplit run would save."""
    g, d = state.gen, state.disc
    return {"gen": tp.full_state_dict(g.module),
            "disc": tp.full_state_dict(d.module),
            "gen_opt": tp.full_optimizer_state_dict(g.optimizer, g.module),
            "disc_opt": tp.full_optimizer_state_dict(d.optimizer, d.module),
            "gen_step": state.gen.step, "disc_step": state.disc.step,
            "epoch": state.epoch, "global_step": state.global_step,
            "seed": seed}


def restore_checkpoint(path: str, state: Optional[GanTrainState] = None):
    """Read a checkpoint; with ``state``, load it into the state's modules
    and optimizers (on their devices) and counters.  Returns the tree.

    A path that does not end in ``.pt``/``.pth`` is a JAX-package flax
    msgpack file, as in ``weather_unet_tpu/cli/common.py``: its raw nested
    dict comes back (``read_msgpack``), and with ``state`` it is loaded as
    the JAX package's ``GanTrainState`` (``_load_jax_gan``).  Split
    networks (``parallel/tp.py``) load this shard's slice of the whole
    tree, so one file restores under any degree."""
    if not path.endswith((".pt", ".pth")):
        tree = read_msgpack(path)
        if state is not None:
            _load_jax_gan(path, tree, state)
        return tree
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if state is not None:
        for ts, key in ((state.gen, "gen"), (state.disc, "disc")):
            tp.load_full_state_dict(ts.module, tree[key])
            tp.load_full_optimizer_state_dict(ts.optimizer, ts.module,
                                              tree[key + "_opt"])
            ts.step = int(tree[key + "_step"])
        state.epoch = int(tree["epoch"])
        state.global_step = int(tree["global_step"])
    return tree


def supervised_tree(state: TrainState, epoch: int, global_step: int,
                    epoch_step: int = 0) -> dict:
    """What a supervised checkpoint holds: the module's state dict
    (parameters and BatchNorm buffers), the Adam state, the update count,
    the epoch still to run, the global step and the position within an
    interrupted epoch.  The tensors are the live ones; saving copies
    them."""
    return {"model": state.module.state_dict(),
            "opt": state.optimizer.state_dict(), "step": state.step,
            "epoch": epoch, "global_step": global_step,
            "epoch_step": epoch_step}


def restore_supervised(path: str, state: TrainState) -> dict:
    """Load a ``supervised_tree`` checkpoint into the state's module and
    optimizer (on their devices) and update count.  Returns the tree.  A
    msgpack file is the JAX package's supervised layout
    (``_load_jax_supervised``); its tree comes back with ``epoch``,
    ``global_step`` and ``epoch_step`` as the resume reads them."""
    if not path.endswith((".pt", ".pth")):
        return _load_jax_supervised(path, read_msgpack(path), state)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    state.module.load_state_dict(tree["model"], strict=True)
    state.optimizer.load_state_dict(tree["opt"])
    state.step = int(tree["step"])
    return tree


class AsyncCheckpointer:
    """Checkpoint writes off the training thread.

    ``save()`` copies the tree to host memory on the calling thread (the
    step loop goes on changing the tensors in place as soon as it returns)
    and hands serialization and the file write to one worker thread.  One
    write is in flight at a time (a second ``save`` first joins the
    previous), which bounds host memory at one snapshot and keeps
    newest-wins ordering.  ``wait()`` joins the pending write and re-raises
    its error: call it before the process exits (preemption), before
    reading ``latest_checkpoint``, and before a rollback restores."""

    def __init__(self):
        # created on the first save: trainers that never save start no thread
        self._pool = None
        self._pending = None

    def save(self, directory: str, name: str, step: int, tree: Any) -> None:
        """Schedule a save; returns once the host copy is taken."""
        self.wait()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt")
        snap = _to_host(tree)
        self._pending = self._pool.submit(
            _write, checkpoint_path(directory, name, step), snap)

    def wait(self) -> Optional[str]:
        """Join the in-flight write (if any); returns its path."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        return pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()
                self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def reference_disc_state_dict(sd) -> dict:
    """SNDisc's state dict as the JAX package exports it: per spectral-norm
    layer ``weight_v`` recomputed from ``weight_orig`` and ``weight_u``
    (``normalize(W^T u)``) and ``weight`` = ``weight_orig / (u W v)``, the
    normalized weight that torch's spectral-norm load hook accepts."""
    out = _to_host(sd)
    for key in [k for k in out if k.endswith(".weight_orig")]:
        name = key[:-len("_orig")]
        w = out[key].numpy()
        w_mat = w.reshape(w.shape[0], -1)
        u = out[name + "_u"].numpy()
        v = w_mat.T @ u
        v = v / (np.linalg.norm(v) + 1e-12)
        out[name] = torch.from_numpy(w / (u @ w_mat @ v))
        out[name + "_v"] = torch.from_numpy(v.astype(w.dtype))
    return out


def export_torch_gan(path: str, gen, disc, epoch: int,
                     global_step: int) -> None:
    """Write a reference-format ``.pt`` GAN checkpoint
    (``t_est_train.py:367-373``): ``{'inference', 'discriminator', 'epoch',
    'global_step'}``.  The port's modules carry the reference key names, so
    the entries are their state dicts, the discriminator's with the JAX
    package's spectral-norm entries (``reference_disc_state_dict``); the
    whole model's where the networks are split (every shard calls it)."""
    _write(path, {"inference": _to_host(tp.full_state_dict(gen)),
                  "discriminator": reference_disc_state_dict(
                      tp.full_state_dict(disc)),
                  "epoch": epoch, "global_step": global_step})


# ---------------------------------------------------------------- msgpack
#
# flax's on-disk format (``flax/serialization.py``): the tree is a msgpack map
# of string keys (sequences become maps keyed "0", "1", ...); an array leaf
# is ext type 1 and a numpy scalar ext type 3, both holding the msgpack
# triple (shape, dtype name, C-order bytes); a complex number is ext type 2,
# (real, imag).  Leaves over MAX_CHUNK_SIZE bytes are split into
# ``{CHUNKED: True, "shape": {...}, "chunks": {...}}`` maps of flat pieces.

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _array_from_bytes(data: bytes):
    """Ext payload -> numpy array, or a bfloat16 tensor (numpy has no
    bfloat16: its bytes are read as int16 and viewed as torch.bfloat16)."""
    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name.decode())).reshape(
        shape, order="C")


def _ext_unpack(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            cat = (torch.cat if isinstance(chunks[0], torch.Tensor)
                   else np.concatenate)
            return cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax ``serialization.msgpack_restore``: bytes -> nested dict with
    numpy array and scalar leaves (bfloat16 ones as torch.bfloat16
    tensors), chunked leaves rejoined."""
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))


def read_msgpack(path: str) -> dict:
    """``restore_checkpoint(path, None)`` of the JAX package: the raw nested
    dict of a flax msgpack file.  Raises ValueError for a file that is not
    one."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        tree = msgpack_restore(data)
    except (ValueError, msgpack.UnpackException) as e:
        raise ValueError(f"{path} is not a flax msgpack checkpoint: "
                         f"{type(e).__name__}: {e}") from e
    if not isinstance(tree, dict):
        raise ValueError(f"{path} is not a flax msgpack checkpoint: its top "
                         f"level is a {type(tree).__name__}, not a map")
    return tree


def _state_dict(tree):
    """flax ``to_state_dict`` of plain containers: dicts keep their order
    with string keys, a namedtuple becomes a map of its fields, any other
    sequence a map keyed by position."""
    if isinstance(tree, dict):
        out = {str(k): _state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError(f"dict keys have no unique string form: "
                             f"{list(tree)}")
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _nbytes(x) -> int:
    return (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
            else x.size * x.dtype.itemsize)


def _chunk(x) -> dict:
    item = x.element_size() if isinstance(x, torch.Tensor) else x.itemsize
    step = max(1, MAX_CHUNK_SIZE // item)
    flat = x.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + step] for i, j in
                       enumerate(range(0, flat.shape[0], step))}}


def _chunk_leaves(tree):
    """Split array leaves over MAX_CHUNK_SIZE bytes (flax descends into maps
    only, and chunks a bare top-level array)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) if isinstance(v, dict)
                else _chunk(v) if (isinstance(v, (np.ndarray, torch.Tensor))
                                   and _nbytes(v) > MAX_CHUNK_SIZE) else v
                for k, v in tree.items()}
    if (isinstance(tree, (np.ndarray, torch.Tensor))
            and _nbytes(tree) > MAX_CHUNK_SIZE):
        return _chunk(tree)
    return tree


def _array_to_bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return msgpack.packb((tuple(x.shape), "bfloat16",
                                  x.view(torch.int16).numpy().tobytes()),
                                 use_bin_type=True)
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return msgpack.ExtType(_EXT_NDARRAY, _array_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def to_bytes(tree) -> bytes:
    """flax ``serialization.to_bytes`` of a tree of dicts, lists, tuples,
    numpy arrays and scalars, torch tensors (bfloat16 too) and Python
    primitives: the same bytes."""
    return msgpack.packb(_chunk_leaves(_state_dict(tree)), default=_ext_pack,
                         strict_types=True)


def _host_tree(tree):
    """The JAX package's ``_to_host`` (``jax.tree.map(np.asarray, tree)``):
    dict keys sorted as JAX flattens them, every leaf an array (a Python
    number becomes a 0-d one; a bfloat16 tensor stays a tensor), None kept."""
    if isinstance(tree, dict):
        return {k: _host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu()
        return tree if tree.dtype == torch.bfloat16 else tree.numpy()
    return np.asarray(tree)


def save_checkpoint_file(path: str, tree: Any) -> str:
    """The JAX package's ``save_checkpoint_file``: ``tree`` as flax msgpack
    at exactly ``path`` (the bytes flax writes for it), through a unique
    temporary file renamed into place."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        f.write(to_bytes(_host_tree(tree)))
    os.replace(tmp, path)
    return path


# ------------------------------------------------- the JAX package's layouts
#
# ``weather_unet_tpu/core/state.py``: a ``GanTrainState`` is ``gen`` and
# ``disc`` (each a ``TrainState``: ``params``, ``opt_state``, ``extra``,
# ``step``), ``spectral`` (SNDisc's ``u`` vectors), ``epoch`` and
# ``global_step``.  The supervised loop saves ``params``, ``batch_stats``,
# ``opt_state``, ``epoch``, ``global_step`` and ``epoch_step``
# (``weather_unet_tpu/train/loops.py:593-620``).  A file is loaded only once
# its whole tree fits the state (the same keys, leaves of the same shapes);
# otherwise the first key that differs is named and nothing is loaded.

def _leaf_shape(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    return tuple(np.shape(x))


def _first_difference(got, want, path: str = "") -> Optional[str]:
    """The first path, in sorted key order, where ``got`` and ``want``
    differ in their keys or in a leaf's shape; None where they agree."""
    if isinstance(want, dict) or isinstance(got, dict):
        if not (isinstance(want, dict) and isinstance(got, dict)):
            return f"{path or '/'} (a map on one side only)"
        for k in sorted(set(got) | set(want)):
            if k not in got:
                return f"{path}/{k} (missing from the file)"
            if k not in want:
                return f"{path}/{k} (not in the state)"
            diff = _first_difference(got[k], want[k], f"{path}/{k}")
            if diff is not None:
                return diff
        return None
    a, b = _leaf_shape(got), _leaf_shape(want)
    if a != b:
        return f"{path} (shape {a} in the file, {b} in the state)"
    return None


def _require_fit(path: str, tree, want) -> None:
    diff = _first_difference(tree, want)
    if diff is not None:
        raise ValueError(f"{path} does not fit the training state: {diff}; "
                         f"nothing was loaded")


def _tensors_of(sd: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _gan_nets(state: GanTrainState):
    return ((state.gen, "gen", cunet_state_dict_from_jax,
             cunet_state_dict_to_jax),
            (state.disc, "disc", sndisc_state_dict_from_jax,
             sndisc_state_dict_to_jax))


def gan_tree_to_jax(state: GanTrainState) -> dict:
    """The state as the JAX package saves a ``GanTrainState``: each
    network's params and optax Adam state, ``spectral``, the counters
    (numpy leaves; ``save_checkpoint_file`` writes it as flax does)."""
    tree = {"epoch": state.epoch, "global_step": state.global_step}
    for ts, key, _, to_jax in _gan_nets(state):
        sd = tp.full_state_dict(ts.module)
        states = (tp.full_param_states(ts.optimizer, ts.module)
                  if tp.layout_of(ts.module) is not None else None)
        variables = to_jax(sd)
        tree[key] = {"params": variables["params"], "extra": None,
                     "opt_state": adam_state_to_jax(ts.optimizer, ts.module,
                                                    to_jax, sd, states),
                     "step": ts.step}
        if "spectral" in variables:
            tree["spectral"] = variables["spectral"]
    return tree


def _load_adam(optimizer: torch.optim.Optimizer, module: torch.nn.Module,
               by_name: dict) -> None:
    """Replace the optimizer's state with ``by_name``'s per-parameter
    states, on each parameter's device (``step`` too where the group is
    ``capturable``); a parameter without one starts fresh."""
    names = {p: n for n, p in module.named_parameters()}
    for group in optimizer.param_groups:
        on_device = group.get("capturable") or group.get("fused")
        for p in group["params"]:
            st = by_name.get(names[p])
            if st is None:
                optimizer.state.pop(p, None)
                continue
            optimizer.state[p] = {
                k: (v.to(p.device) if k != "step" or on_device else v)
                for k, v in st.items()}


def _load_jax_gan(path: str, tree: dict, state: GanTrainState) -> None:
    """Load a JAX ``GanTrainState`` tree: weights through the converters
    (the cUNet's unused ``adain{i}.emb``, absent from JAX, keeps its
    value), Adam's moments and count, ``u`` (``weight_v`` recomputed from
    it), both update counts, the epoch and the global step."""
    _require_fit(path, tree, gan_tree_to_jax(state))
    loads = []
    for ts, key, from_jax, _ in _gan_nets(state):
        sub = tree[key]
        coll = {"spectral": tree["spectral"]} if key == "disc" else {}
        current = tp.full_state_dict(ts.module)
        sd = {k: current[k] if ".emb." in k else v for k, v in
              _tensors_of(from_jax({"params": sub["params"], **coll}))
              .items()}
        adam = adam_state_from_jax(sub["opt_state"], ts.module, from_jax,
                                   coll)
        loads.append((ts, sd, adam, int(np.asarray(sub["step"]))))
    for ts, sd, adam, step in loads:
        tp.load_full_state_dict(ts.module, sd)
        _load_adam(ts.optimizer, ts.module,
                   tp.shard_param_states(adam, ts.module))
        ts.step = step
    state.epoch = int(np.asarray(tree["epoch"]))
    state.global_step = int(np.asarray(tree["global_step"]))


def supervised_tree_to_jax(state: TrainState, epoch: int, global_step: int,
                           epoch_step: int = 0) -> dict:
    """A ResNet's supervised state as the JAX package's loop saves it
    (the inverse of ``_load_jax_supervised``'s newest layout)."""
    variables = resnet_state_dict_to_jax(state.module.state_dict())
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "opt_state": adam_state_to_jax(state.optimizer, state.module,
                                           resnet_state_dict_to_jax),
            "epoch": epoch, "global_step": global_step,
            "epoch_step": epoch_step}


# the JAX loop's layouts, newest first, by the fields each lacks
_SUPERVISED_LAYOUTS = ((), ("epoch_step",), ("epoch_step", "opt_state"))


def _load_jax_supervised(path: str, tree: dict, state: TrainState) -> dict:
    """Load the JAX supervised loop's checkpoint into a ResNet's state, in
    any of the three layouts that loop accepts: the newest; the one
    without ``epoch_step`` (the resume starts the epoch over); the oldest,
    params-only one, whose ``epoch`` is the epoch it completed (so the
    resume starts at ``epoch + 1``) and which keeps the optimizer's
    current state.  BatchNorm's ``num_batches_tracked``, which JAX does not
    keep, and the update count become the global step."""
    full = supervised_tree_to_jax(state, 0, 0, 0)
    drop = next((d for d in _SUPERVISED_LAYOUTS
                 if set(tree) == set(full) - set(d)), ())
    _require_fit(path, tree, {k: v for k, v in full.items()
                              if k not in drop})
    global_step = int(np.asarray(tree["global_step"]))
    variables = {"params": tree["params"],
                 "batch_stats": tree["batch_stats"]}
    sd = _tensors_of(resnet_state_dict_from_jax(variables))
    for k in [k for k in sd if k.endswith("num_batches_tracked")]:
        sd[k] = torch.tensor(global_step, dtype=torch.long)
    adam = (None if "opt_state" in drop else adam_state_from_jax(
        tree["opt_state"], state.module, resnet_state_dict_from_jax,
        {"batch_stats": tree["batch_stats"]}))
    state.module.load_state_dict(sd, strict=True)
    if adam is not None:
        _load_adam(state.optimizer, state.module, adam)
    state.step = global_step
    epoch = int(np.asarray(tree["epoch"])) + ("opt_state" in drop)
    return {"epoch": epoch, "global_step": global_step,
            "epoch_step": int(np.asarray(tree.get("epoch_step", 0)))}
