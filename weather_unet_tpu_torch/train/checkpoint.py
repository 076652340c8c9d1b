"""Checkpoint save/restore with auto-resume -- the port of
``weather_unet_tpu/train/checkpoint.py``, in a torch-native format.

As in the JAX package (SURVEY.md §5): GAN runs save every 1000 steps under
``save_dir/name`` and auto-resume from the newest file
(``t_est_train.py:151-163,365-373``); unlike the reference, the optimizer
state is saved too, so a resume is exact.  One file per save,
``ckpt_s{step:010d}.pt`` (``torch.save`` of a dict of tensors and numbers,
loaded with ``weights_only=True``), written under a unique temporary name
and renamed into place; the newest name wins.  ``export_torch_gan`` writes
the reference's ``.pt`` GAN bundle; ``supervised_tree`` /
``restore_supervised`` hold the supervised loop's state.

The JAX package's checkpoints are flax msgpack files; ``msgpack_restore`` /
``restore_checkpoint`` read them and ``to_bytes`` / ``save_checkpoint_file``
write the same bytes as flax, with ``msgpack`` alone (no flax, no JAX).
Resuming a JAX *training* run from one (optax's Adam state into
``torch.optim.Adam``) is not ported yet (``ROADMAP.md`` queue 1, "JAX
training state"); serving and evaluation read its weights.
"""

from __future__ import annotations

import os
import re
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from weather_unet_tpu_torch.core.state import GanTrainState, TrainState

_CKPT_RE = re.compile(r"ckpt_s\d+\.pt$")


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


def _write(path: str, host_tree: Any) -> str:
    """Write a host tree to ``path`` through a unique temporary file."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # a unique staging name: two writers of one step never share a file
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    torch.save(host_tree, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(directory: str, name: str) -> Optional[str]:
    """Path of the newest checkpoint under ``directory/name``, or None."""
    out_dir = os.path.join(directory, name)
    if not os.path.isdir(out_dir):
        return None
    cands = sorted(f for f in os.listdir(out_dir) if _CKPT_RE.match(f))
    return os.path.join(out_dir, cands[-1]) if cands else None


def gan_tree(state: GanTrainState, seed: int) -> dict:
    """What a GAN checkpoint holds: both networks' state dicts (D's with its
    spectral-norm ``weight_u`` / ``weight_v`` buffers), both Adam states,
    the update counts, the epoch, the global step and the trainer's seed.
    The tensors are the live ones; saving copies them."""
    return {"gen": state.gen.module.state_dict(),
            "disc": state.disc.module.state_dict(),
            "gen_opt": state.gen.optimizer.state_dict(),
            "disc_opt": state.disc.optimizer.state_dict(),
            "gen_step": state.gen.step, "disc_step": state.disc.step,
            "epoch": state.epoch, "global_step": state.global_step,
            "seed": seed}


def restore_checkpoint(path: str, state: Optional[GanTrainState] = None):
    """Read a checkpoint; with ``state``, load it into the state's modules
    and optimizers (on their devices) and counters.  Returns the tree.

    A path that does not end in ``.pt``/``.pth`` is a JAX-package flax
    msgpack file, as in ``weather_unet_tpu/cli/common.py``: its raw nested
    dict comes back (``read_msgpack``); loading one into ``state`` is not
    ported yet."""
    if not path.endswith((".pt", ".pth")):
        if state is not None:
            raise NotImplementedError(
                f"{path}: resuming a JAX training run from its msgpack "
                f"checkpoint is not ported yet ({JAX_STATE_ITEM}); the "
                f"weights load for serving and evaluation")
        return read_msgpack(path)
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if state is not None:
        for ts, key in ((state.gen, "gen"), (state.disc, "disc")):
            ts.module.load_state_dict(tree[key], strict=True)
            ts.optimizer.load_state_dict(tree[key + "_opt"])
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
    optimizer (on their devices) and update count.  Returns the tree."""
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
    package's spectral-norm entries (``reference_disc_state_dict``)."""
    torch.save({"inference": _to_host(gen.state_dict()),
                "discriminator": reference_disc_state_dict(disc.state_dict()),
                "epoch": epoch, "global_step": global_step}, path)


# ---------------------------------------------------------------- msgpack
#
# flax's on-disk format (``flax/serialization.py``): the tree is a msgpack map
# of string keys (sequences become maps keyed "0", "1", ...); an array leaf
# is ext type 1 and a numpy scalar ext type 3, both holding the msgpack
# triple (shape, dtype name, C-order bytes); a complex number is ext type 2,
# (real, imag).  Leaves over MAX_CHUNK_SIZE bytes are split into
# ``{CHUNKED: True, "shape": {...}, "chunks": {...}}`` maps of flat pieces.

JAX_STATE_ITEM = "ROADMAP.md queue 1, 'JAX training state'"
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
