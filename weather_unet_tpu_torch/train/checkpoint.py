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
``restore_supervised`` hold the supervised loop's state.  Reading the JAX
package's flax msgpack files is not ported yet (``ROADMAP.md`` queue 1,
item 6).
"""

from __future__ import annotations

import os
import re
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

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
    and optimizers (on their devices) and counters.  Returns the tree."""
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


def _reference_disc_sd(sd) -> dict:
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
    package's spectral-norm entries (``_reference_disc_sd``)."""
    torch.save({"inference": _to_host(gen.state_dict()),
                "discriminator": _reference_disc_sd(disc.state_dict()),
                "epoch": epoch, "global_step": global_step}, path)
