"""The training loops -- the port of ``weather_unet_tpu/train/loops.py``:
``WeatherTransferTrainer`` (the GAN loop, reference ``WeatherTransfer``
driver, ``t_est_train.py:59-400``) and ``train_supervised`` (the classifier
and estimator loop, ``classifier.py:132-182``, ``estimator.py:170-227``):
steps, data, checkpoints, preemption and summaries on one device.

``aot_cache`` puts the steps through the AOT tier (``core/aot.py``): on a
CUDA device each step program (the trainer's D-only and D+G steps, the
supervised step) is captured once as a CUDA graph of its whole forward,
backward and Adam update (Adam made ``capturable``) and replayed each step.  ``profile_dir`` traces ``fit`` with
``torch.profiler`` (``core/profiling.py::trace``).

Both loops auto-resume from the newest checkpoint under ``save_dir/name``:
the port's ``.pt`` or the JAX package's ``.msgpack``, so a JAX run's
directory resumes here (``train/checkpoint.py``); the loops write ``.pt``.

``plan`` (``parallel/mesh.py::MeshPlan``; the default under a process
group, ``parallel/launch.py``) trains over a (data, model) grid of ranks,
one rank a process: each data row of ranks steps on its rows of the
global batch (the loaders' ``process_shard``), the steps all-reduce
gradients and metrics over each rank's data group, the state is
broadcast from the data group's first rank once built, each data row's
dropout (and device augment) generator folds in its data index, so the
ranks of one row draw the same masks, evaluation sums its weighted
metrics over the data rows, rank 0 alone writes summaries, and every
rank writes the same checkpoint bytes to the same file.  Without
``tensor_parallel`` each model position holds a full replica, as in the
JAX package; with it (``WeatherTransferTrainer``) every double conv of
both networks is split over the rank's model group
(``parallel/tp.py``), and each save gathers the whole state.
``aot_cache`` under a process group is ignored with the JAX package's
warning: a CUDA graph cannot hold a gloo collective.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from weather_unet_tpu_torch._device import DeviceLike, resolve_device
from weather_unet_tpu_torch.core.aot import AotCache, AotJit
from weather_unet_tpu_torch.core.optim import set_capturable
from weather_unet_tpu_torch.core.profiling import trace
from weather_unet_tpu_torch.core.rng import fold_seed, train_generator
from weather_unet_tpu_torch.core.state import TrainState
from weather_unet_tpu_torch.data.pipeline import device_prefetch
from weather_unet_tpu_torch.data.transforms import (
    AugmentConfig, augment_batch, normalize_batch)
from weather_unet_tpu_torch.models.common import sync_batchnorm
from weather_unet_tpu_torch.parallel import tp
from weather_unet_tpu_torch.parallel.launch import (
    data_count, data_index, lockstep_compile, process_index)
from weather_unet_tpu_torch.parallel.mesh import (
    all_reduce_mean, broadcast_module_, data_parallel, make_mesh,
    require_model_axis)
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_eval_step, make_gan_step)
from weather_unet_tpu_torch.train.metrics import SummaryWriter, run_comment
from weather_unet_tpu_torch.train.preemption import GracefulShutdown
from weather_unet_tpu_torch.train.supervised import stepped


def _data_plan(plan, batch_size, what: str):
    """The plan a loop trains under: ``plan``, or under a process group the
    default one over the world (as the JAX loops' ``make_mesh``), or None.
    Refuses a process holding several of the plan's devices (one rank a
    process: ``parallel/launch.py``) and a global batch that does not
    divide over the data rows."""
    if plan is None and data_parallel():
        plan = make_mesh(batch_size=batch_size)
    if plan is None:
        return None
    if len(plan.devices) != 1:
        raise ValueError(
            f"{what} trains one device a process, but this process holds "
            f"{len(plan.devices)} of the plan's devices; launch one rank a "
            f"device: python -m weather_unet_tpu_torch.parallel.launch -n K")
    if batch_size is not None and batch_size % plan.n_data:
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{plan.n_data} data rows of ranks")
    return plan


def _tiered_steps(fns, aot_cache):
    """The AOT tier shared by both training loops: ``fns`` are step
    programs ``program(state, *inputs) -> metrics``; returns ``(callables,
    cache)``, the programs through ``AotJit`` with the state updated in
    place and the shared ``AotCache``, or the programs themselves and None
    without ``aot_cache``.  Nothing is kept on disk: a CUDA graph cannot
    outlive its process (``core/aot.py``).  Under a process group the tier
    is ignored with the JAX package's warning and the steps run eagerly."""
    if aot_cache is not None and data_parallel():
        print("WARNING: --aot_cache is single-process only; ignoring it "
              "for this multi-process run", flush=True)
        aot_cache = None
    if aot_cache is None:
        return [lockstep_compile(fn, "step") for fn in fns], None
    cache = (aot_cache if isinstance(aot_cache, AotCache)
             else AotCache(aot_cache))
    return [AotJit(fn, cache, inplace_argnums=(0,)) for fn in fns], cache


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).cpu().numpy()


class WeatherTransferTrainer:
    """GAN weather-transfer training (reference ``t_est_train.py`` /
    ``t_cls_train.py`` drivers).

    ``est_apply(images NCHW) -> (B, num_classes)`` is the frozen weather
    net's raw output (signals or logits), differentiable with respect to
    its input (``cli/common.py::load_step_estimator`` builds it).  The
    cadences are the reference's: a checkpoint and an evaluation every
    ``EVAL_PER_STEP`` steps, summaries every ``DISPLAY_PER_STEP``, the
    generator updated every ``gd_train_ratio``-th step
    (``t_est_train.py:350-399``).  On CUDA the generator's decoder runs K1
    and K2 (``use_pallas``).  ``device`` is CUDA unless given.

    By default augmentation happens in the loader threads and the step's
    input is only normalized on the device; ``device_augment`` warps both
    batches on the device instead (``transforms.augment_batch``: rotation
    and hflip, with ``augment`` also the resized crop and the jitter
    0.5 / 0.3 / 0.3), each step's generator seeded from ``(seed + 3,
    global step)`` so a resumed run replays the warps.

    ``plan``: over the plan's grid of ranks (module docstring); the
    loaders then yield each rank's ``cfg.batch_size / data rows`` rows.
    ``tensor_parallel`` (a plan with a model axis of at least 2, else
    the JAX package's ``ValueError``): both networks split over each
    rank's model group (``parallel/tp.py``), the optimizers' moments
    shard-shaped, each checkpoint the whole state gathered, and on CUDA
    cuDNN's deterministic algorithms, so that the layers every shard
    runs whole get equal gradients on every shard.
    ``aot_cache`` (a directory or ``AotCache``, exposed as ``self.aot``):
    both step programs, D-only and D+G, run through the AOT tier, on CUDA as
    CUDA graphs captured at their first step (module docstring).
    ``profile_dir``: ``fit`` runs under ``torch.profiler`` and writes a
    Chrome trace there, also when it raises.  The profiler keeps every
    event of the whole ``fit`` in host memory until then, so profile a run
    of a few steps.
    """

    EVAL_PER_STEP = 1000
    DISPLAY_PER_STEP = 1000

    def __init__(self, cfg: GanConfig, est_apply: Callable, *,
                 save_dir: str = "cp/transfer", name: str = "cUNet",
                 log_dir: str = "runs", augment: bool = False,
                 device_augment: bool = False,
                 plan=None, seed: int = 0,
                 export_torch: bool = False,
                 profile_dir: Optional[str] = None, nan_guard: bool = False,
                 max_rollbacks: int = 3, aot_cache: Optional[str] = None,
                 tensor_parallel: bool = False, device: DeviceLike = None):
        self.plan = _data_plan(plan, cfg.batch_size, "the GAN trainer")
        if tensor_parallel:
            require_model_axis(self.plan)
        self.cfg = cfg
        self.name = name
        self.save_dir = save_dir
        self.export_torch = export_torch
        self.seed = seed
        self.device = resolve_device(
            device if device is not None or self.plan is None
            else self.plan.devices[0])
        # rows (and seeds) are the data row's: the ranks of one row hold
        # the shards of one model, or replicas, and see the same rows
        self._n_data = data_count() if self.plan else 1
        self._rank = process_index()
        self._local_batch = cfg.batch_size // self._n_data
        # summaries come from rank 0 alone
        self.writer = (SummaryWriter(log_dir, comment=run_comment(
            cfg.lr, cfg.batch_size, cfg.num_epoch, name))
            if self._rank == 0 else None)

        self.gen, self.disc, self.state = build_gan_state(
            cfg, seed, self.device, use_pallas=self.device.type == "cuda")
        if tensor_parallel:
            # before any optimizer state exists: the shards swap the
            # parameters' data, which the optimizers keep
            tp.shard_gan_(self.gen, self.disc, tp.process_shards())
            if self.device.type == "cuda":
                torch.backends.cudnn.deterministic = True
                torch.backends.cudnn.benchmark = False
        self._ckpt = ckpt.AsyncCheckpointer()
        # host-side step mirror; the last checkpointed step guards the
        # terminal save
        self._gstep = self._saved_step = 0
        # the tier graphs the whole step, Adam's update included, which
        # needs Adam's step count on the card
        self._capturable = aot_cache is not None and (
            self.device.type == "cuda")
        self._step = make_gan_step(self.gen, self.disc, est_apply, cfg)
        programs = self._step.programs
        tiered, self.aot = _tiered_steps(
            [programs[True], programs[False]], aot_cache)
        programs[True], programs[False] = tiered
        self._set_capturable()
        self._resume()
        if self.plan is not None:
            for m in (self.gen, self.disc):
                broadcast_module_(m)
        self._eval = make_eval_step(self.gen, self.disc, est_apply, cfg)
        self.profile_dir = profile_dir

        # each step's dropout generator is seeded from (base, global step);
        # with several data rows the base folds in the data index, so the
        # rows' shards do not share masks and a row's model ranks do
        self._base_seed = self._rank_seed(seed + 1)
        self._aug_seed = self._rank_seed(seed + 3)
        self._step_rng = torch.Generator(device=self.device)
        self._eval_rng = train_generator(seed + 2, self.device)
        self._aug_cfg = None
        if device_augment:
            self._aug_cfg = AugmentConfig(
                out_size=cfg.input_size, resized_crop=augment,
                brightness=0.5 if augment else 0.0,
                contrast=0.3 if augment else 0.0,
                saturation=0.3 if augment else 0.0)
            self._aug_rng = torch.Generator(device=self.device)
        self.scalar_dict = {}
        self.image_dict = {}
        self._last_metrics = None    # device tensors, read at the summary
        self._all_step = 0
        self._window_t0 = None
        self._window_steps = 0
        self.nan_guard = nan_guard
        self.max_rollbacks = max_rollbacks
        self._rollbacks = 0

    def _rank_seed(self, seed: int) -> int:
        return seed if self._n_data == 1 else fold_seed(seed, data_index())

    # ------------------------------------------------------------- state io
    def _resume(self):
        path = ckpt.latest_checkpoint(self.save_dir, self.name)
        if path:
            self._restore(path)
            print(f"resumed from {path} at step {self.state.global_step}",
                  flush=True)
            self._gstep = self._saved_step = self.state.global_step

    def _set_capturable(self):
        for ts in (self.state.gen, self.state.disc):
            set_capturable(ts.optimizer, self._capturable)

    def _restore(self, path: str):
        """Restore ``path`` (the port's ``.pt`` or a JAX ``GanTrainState``
        ``.msgpack``) into the state.  The modules load in place, but
        the optimizers' load replaces their state tensors, so the step
        programs' graphs (captured on the old ones) are dropped and
        captured again at the next step."""
        ckpt.restore_checkpoint(path, self.state)
        self._set_capturable()
        for program in self._step.programs.values():
            if isinstance(program, AotJit):
                program.reset()

    def _save(self):
        """Checkpoint on the checkpointer's thread (the host copy is taken
        here); with ``export_torch`` also the reference ``.pt`` bundle."""
        step = self.state.global_step
        self._ckpt.save(self.save_dir, self.name, step,
                        ckpt.gan_tree(self.state, self.seed))
        self._saved_step = step
        if self.export_torch:
            out = os.path.join(
                self.save_dir, self.name,
                f"{self.name}_e{self.state.epoch:04d}_s{step}.pt")
            ckpt.export_torch_gan(out, self.gen, self.disc, self.state.epoch,
                                  step)

    # ------------------------------------------------------------- training
    def train_epoch(self, train_loader: Iterable, random_loader: Iterable,
                    test_batches=None, labeled: bool = False,
                    stop: Optional[GracefulShutdown] = None,
                    skip_batches: int = 0) -> bool:
        """One epoch over the zipped content and condition streams
        (``t_est_train.py:362``).  Batches are ``(uint8 NHWC images,
        cond...)`` tuples from ``BatchLoader``; ``labeled`` reads field 1 as
        int class ids (cls mode).  ``skip_batches`` fast-forwards past
        batches a preempted run already trained on (they are loaded, not
        copied to the device).  Returns False when stopped by ``stop``."""
        cfg = self.cfg
        try:    # the lambda ramp's denominator (t_est_train.py:355)
            self._all_step = cfg.num_epoch * len(train_loader)
        except TypeError:
            self._all_step = 0
        tl_it, rl_it = iter(train_loader), iter(random_loader)
        if skip_batches:
            tl_it = itertools.islice(tl_it, skip_batches, None)
            rl_it = itertools.islice(rl_it, skip_batches, None)
        # only the images go through the prefetch; labels are B ints
        zipped = zip(
            device_prefetch(tl_it, self.device, device_fields=[0]),
            device_prefetch(rl_it, self.device, device_fields=[0]))
        zeros = torch.zeros(self._local_batch, dtype=torch.long,
                            device=self.device)
        # no device -> host read in this loop: metrics stay on the device
        # until the summary cadence
        for data, rand_data in zipped:
            if stop is not None and stop.requested:
                # preemption: persist at the step boundary and stop; resume
                # restores this state and fit() fast-forwards the epoch
                if self.nan_guard and self._nonfinite_metrics():
                    # a diverged state must never become the newest
                    # checkpoint (it would poison resume and rollback)
                    print(f"preemption: signal {stop.signum} at step "
                          f"{self._gstep}, but metrics are non-finite — NOT "
                          f"checkpointing the diverged state (resume will "
                          f"use the last good checkpoint)", flush=True)
                    self._ckpt.wait()
                    return False
                print(f"preemption: signal {stop.signum} — checkpointing at "
                      f"step {self._gstep} and stopping", flush=True)
                self._save()
                self._ckpt.wait()   # the grace window must see the file
                return False
            if data[0].shape[0] != self._local_batch:
                if self._n_data > 1 and data[0].shape[0] == cfg.batch_size:
                    raise ValueError(
                        "the loaders yield the global batch on every rank; "
                        "give them process_shard=True")
                continue
            if labeled:
                c_d = torch.as_tensor(data[1]).to(self.device, torch.long)
                c_r = torch.as_tensor(rand_data[1]).to(self.device,
                                                       torch.long)
            else:
                c_d = c_r = zeros

            self._gstep += 1
            gstep = self._gstep
            do_g = gstep % cfg.gd_train_ratio == 0
            if self._window_t0 is None:
                self._window_t0 = time.perf_counter()
            if self._aug_cfg is None:
                images = normalize_batch(data[0], cfg.input_size)
                rand = normalize_batch(rand_data[0], cfg.input_size)
            else:
                self._aug_rng.manual_seed(fold_seed(self._aug_seed, gstep))
                images = augment_batch(self._aug_rng, data[0], self._aug_cfg)
                rand = augment_batch(self._aug_rng, rand_data[0],
                                     self._aug_cfg)
            self._step_rng.manual_seed(fold_seed(self._base_seed, gstep))
            self.state, metrics = self._step(
                self.state, images, c_d, rand, c_r, self._step_rng,
                do_g=do_g)
            self._last_metrics = metrics
            self._window_steps += 1

            if gstep % self.EVAL_PER_STEP == 0:
                # failure detection before the save: a diverged state must
                # not become the newest checkpoint
                if self._maybe_rollback():
                    continue
                if self.nan_guard and self._nonfinite_metrics():
                    continue
                self._save()
                if test_batches is not None:
                    self.evaluate(test_batches)
            if gstep % self.DISPLAY_PER_STEP == 0:
                self.update_summary()
        self.state.epoch += 1
        self._ckpt.wait()   # this epoch's cadence saves are on disk now
        return True

    def _nonfinite_metrics(self) -> list:
        """Names of the non-finite entries of the latest step's metrics (one
        device read; [] before the first step)."""
        if self._last_metrics is None:
            return []
        return [k for k, v in self._last_metrics.items()
                if not np.isfinite(float(v))]

    def _maybe_rollback(self) -> bool:
        """With ``nan_guard``, when the latest metrics are non-finite:
        restore the newest checkpoint and go on with re-seeded dropout, so
        the retry does not replay the diverging trajectory.  At most
        ``max_rollbacks`` times.  The data stream is not rewound.  Returns
        True when it rolled back."""
        if not self.nan_guard:
            return False
        bad = self._nonfinite_metrics()
        if not bad:
            return False
        self._ckpt.wait()   # the newest checkpoint may still be in flight
        path = ckpt.latest_checkpoint(self.save_dir, self.name)
        if path is None or self._rollbacks >= self.max_rollbacks:
            print(f"WARNING: non-finite metrics {bad} at step {self._gstep} "
                  f"and no rollback available (checkpoint={path}, "
                  f"rollbacks={self._rollbacks}/{self.max_rollbacks})",
                  flush=True)
            return False
        self._rollbacks += 1
        self._restore(path)
        self._gstep = self.state.global_step
        self._base_seed = fold_seed(self._base_seed, self._rollbacks)
        self._last_metrics = None    # do not log the diverged values
        self._window_t0 = None       # the window spanned the restore
        self._window_steps = 0
        print(f"nan_guard: non-finite metrics {bad} — rolled back to {path} "
              f"(step {self._gstep}, retry {self._rollbacks}/"
              f"{self.max_rollbacks}, re-seeded)", flush=True)
        return True

    def evaluate(self, test_batches):
        """Reference ``evaluation()`` (``t_est_train.py:285-334``) on two
        cached test batches ``((images, labels), (ref_images, ref_labels))``
        on the device: batch 0 translated to each of batch 1's
        conditions."""
        (images, labels), (_, ref_labels) = test_batches
        metrics, fakes = self._eval(self.state, images, labels, ref_labels,
                                    self._eval_rng)
        self.scalar_dict.update(
            {f"losses/{k}/test": float(v) for k, v in metrics.items()})
        self.image_dict["images/test"] = np.concatenate(
            [_nhwc(images)] + [_nhwc(f) for f in fakes], axis=2)

    def update_summary(self):
        """The only place training metrics are read back to the host; the
        reads wait for every step issued, so the window's wall clock is the
        steps' throughput (``perf/images_per_sec``)."""
        step = self._gstep
        if self._last_metrics is not None:
            vals = {k: float(v) for k, v in self._last_metrics.items()}
            bad = [k for k, v in vals.items() if not np.isfinite(v)]
            if bad:
                print(f"WARNING: non-finite training metrics at step {step}: "
                      f"{bad} — run may have diverged", flush=True)
            self.scalar_dict.update(
                {f"losses/{k}/train": v for k, v in vals.items()})
        if self._all_step:   # the lmda ramp (t_est_train.py:254,376-379)
            self.scalar_dict["variables/lmda"] = (
                self.cfg.lmda if self.cfg.lmda else step / self._all_step)
        if self._window_steps and self._window_t0 is not None:
            dt = time.perf_counter() - self._window_t0
            self.scalar_dict["perf/steps_per_sec"] = self._window_steps / dt
            self.scalar_dict["perf/step_time_ms/mean"] = (
                dt / self._window_steps * 1e3)
            self.scalar_dict["perf/images_per_sec"] = (
                self._window_steps * self.cfg.batch_size / dt)
        self._window_t0 = time.perf_counter()
        self._window_steps = 0
        if self.writer is not None:
            if self.scalar_dict:
                self.writer.add_scalars(self.scalar_dict, step)
            for tag, imgs in self.image_dict.items():
                self.writer.add_image_grid(tag, imgs, step)
        self.image_dict = {}

    def _epoch_skip(self, tl, rl, abs_ep: int) -> int:
        """Batches of epoch ``abs_ep`` that a resumed run already trained
        on: with both loaders sized and ``drop_last``, an epoch is exactly
        ``min(len(tl), len(rl))`` steps, so the position in the epoch is
        ``global_step - abs_ep * steps_per_epoch`` and the replay
        (``set_epoch`` fixes the order) can be fast-forwarded.  Otherwise 0:
        the epoch replays from its start, as a relaunch under the
        reference's auto-resume would (``t_est_train.py:151-163``)."""
        try:
            spe = min(len(tl), len(rl))
        except TypeError:
            return 0
        if not spe or not all(getattr(ld, "drop_last", False)
                              for ld in (tl, rl)):
            return 0
        skip = self._gstep - abs_ep * spe
        # skip == spe: a save on the epoch's last step (before the epoch
        # count moved): the whole epoch is trained, so skip all of it
        if 0 < skip <= spe:
            print(f"resume: fast-forwarding {skip}/{spe} batches of epoch "
                  f"{abs_ep} (already trained before preemption)", flush=True)
            return skip
        return 0

    def fit(self, train_loader_fn: Callable[[], Iterable],
            random_loader_fn: Callable[[], Iterable], test_batches=None,
            labeled: bool = False):
        """Train from the current (resumed) epoch to ``cfg.num_epoch``, each
        epoch on fresh loaders set to the absolute epoch, then save the
        final state if the cadence did not; under ``torch.profiler`` with
        ``profile_dir``."""
        try:
            with trace(self.profile_dir), GracefulShutdown() as stop:
                while self.state.epoch < self.cfg.num_epoch:
                    tl, rl = train_loader_fn(), random_loader_fn()
                    abs_ep = self.state.epoch
                    for ld in (tl, rl):
                        se = getattr(ld, "set_epoch", None)
                        if se is not None:
                            se(abs_ep)
                    if not self.train_epoch(
                            tl, rl, test_batches=test_batches,
                            labeled=labeled, stop=stop,
                            skip_batches=self._epoch_skip(tl, rl, abs_ep)):
                        print("Done: training (preempted)", flush=True)
                        return
                # terminal save, unless the state diverged
                if self._gstep != self._saved_step and not (
                        self.nan_guard and self._nonfinite_metrics()):
                    self._save()
            print("Done: training", flush=True)
        finally:
            # join the write and release the worker thread
            self._ckpt.close()


@contextlib.contextmanager
def _synced_bn(model, on: bool):
    """The model's BatchNorms reduce their moments over the ranks inside."""
    if on:
        sync_batchnorm(model, True)
    try:
        yield
    finally:
        if on:
            sync_batchnorm(model, False)


def _over_ranks(test_accum: list, counts: list):
    """Each eval batch's metrics over every data row's real rows, and the
    rows: the data group's weighted sums (metric x rows) and rows in one
    all-reduce bucket."""
    keys = list(test_accum[0])
    n = torch.tensor(counts, dtype=torch.float32,
                     device=test_accum[0][keys[0]].device)
    rows = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in test_accum]) * n[:, None]
    rows, n = all_reduce_mean([rows, n])      # the ratios are the sums'
    means = (rows / n[:, None]).tolist()
    return ([dict(zip(keys, r)) for r in means],
            [round(c * data_count()) for c in n.tolist()])


def _padded_eval_batches(loader, counts: list):
    """Yield ``(images, targets, weights)`` eval batches with a partial
    batch padded (last row repeated) up to the first batch's size, so the
    tail of a ``drop_last=False`` test split is evaluated, not dropped (the
    reference DataLoader keeps it).  Padded rows carry weight 0; each
    batch's real row count is appended to ``counts`` for the weighted
    aggregation."""
    target = None
    for b in loader:
        x, t = np.asarray(b[0]), np.asarray(b[1])
        n = x.shape[0]
        if target is None:
            target = n
        if n < target:
            x = np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)])
            t = np.concatenate([t, np.repeat(t[-1:], target - n, axis=0)])
        w = np.zeros(max(n, target), np.float32)
        w[:n] = 1.0
        counts.append(n)
        yield x, t, w


def train_supervised(step_fn: Callable, eval_fn: Callable,
                     train_loader_fn: Callable[[], Iterable],
                     test_loader_fn: Callable[[], Iterable], *,
                     state: TrainState, num_epoch: int, writer=None,
                     augment_cfg: Optional[AugmentConfig] = None,
                     input_size: int = 224, save_dir: str = "cp",
                     name: str = "model", eval_per_iter: int = 100,
                     save_per_epoch: int = 5,
                     target_dtype: torch.dtype = torch.float32,
                     seed: int = 0, plan=None,
                     batch_size: Optional[int] = None,
                     aot_cache: Optional[str] = None) -> TrainState:
    """The classifier/estimator loop (reference ``classifier.py:132-182``,
    ``estimator.py:170-227``) on the device of ``state.module``: an eval
    sweep every ``eval_per_iter`` steps, a checkpoint every
    ``save_per_epoch`` epochs and at the end, auto-resume from the newest
    checkpoint with a fast-forward past the batches an interrupted epoch
    already trained on, a checkpoint and a clean stop on SIGTERM/SIGINT.

    ``step_fn(state, images NCHW, targets) -> (state, metrics)`` updates
    the state in place (``train/supervised.py``); ``eval_fn(model, images,
    targets, weights)`` returns metric tensors.  Batches are
    ``(uint8 NHWC images, targets, ...)``.  ``augment_cfg=None`` expects
    the loader threads to augment and only normalizes (resizing to
    ``input_size``) on the device; a config warps on the device
    (``transforms.augment_batch``), each step's generator seeded from
    ``(seed, global step)``.  ``aot_cache``: ``step_fn.program`` (the
    steps of ``train/supervised.py`` have one) runs through the AOT tier,
    on CUDA as a CUDA graph with Adam made ``capturable`` (the caller's
    optimizer stays so).

    ``plan`` (the default under a process group, over ``batch_size``, the
    global batch): over the plan's grid of ranks (module docstring; a
    model axis holds replicas).  The loaders yield each data row's rows
    (``process_shard``); with several data rows the model's BatchNorms
    reduce their train-mode moments over the data group for the run
    (``models/common.py::sync_batchnorm``), and the test loader must
    give every rank the same number of batches (the CLIs' ``drop_last``).
    """
    plan = _data_plan(plan, batch_size, "train_supervised")
    world = data_count() if plan is not None else 1
    if aot_cache is not None and not hasattr(step_fn, "program"):
        raise ValueError("aot_cache needs a step with a device program "
                         "(train/supervised.py::stepped)")
    model = state.module
    device = next(model.parameters()).device
    out_size = augment_cfg.out_size if augment_cfg else input_size
    aug_rng = (torch.Generator(device=device) if augment_cfg is not None
               else None)
    def to_device(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device, dtype)

    global_step, start_epoch, resume_epoch_step = 0, 0, 0
    path = ckpt.latest_checkpoint(save_dir, name)
    if path is not None:
        restored = ckpt.restore_supervised(path, state)
        global_step = int(restored["global_step"])
        start_epoch = int(restored["epoch"])
        resume_epoch_step = int(restored["epoch_step"])
        print(f"resumed from {path} at step {global_step}"
              + (f" (epoch {start_epoch} batch {resume_epoch_step})"
                 if resume_epoch_step else ""), flush=True)

    if plan is not None:
        broadcast_module_(model)
    if process_index() != 0:
        writer = None                     # summaries come from rank 0
    aug_seed = seed if world == 1 else fold_seed(seed, data_index())

    # after the restore: its load replaces the optimizer's tensors and takes
    # the capturable flag from the file, whichever side of the tier wrote it
    set_capturable(state.optimizer, aot_cache is not None
                   and device.type == "cuda" and not data_parallel())
    if aot_cache is not None:
        (program,), _ = _tiered_steps([step_fn.program], aot_cache)
        step_fn = stepped(program)

    ckpter = ckpt.AsyncCheckpointer()
    saved_step = global_step   # last checkpointed step (terminal save guard)

    def save(epoch, global_step, epoch_step=0):
        nonlocal saved_step
        saved_step = global_step
        # the host copy is taken here, the write runs on the checkpointer's
        # thread; epoch_step lets a resume fast-forward an interrupted epoch
        ckpter.save(save_dir, name, global_step, ckpt.supervised_tree(
            state, epoch, global_step, epoch_step))

    train_metrics = []
    warned_empty_test = False
    with GracefulShutdown() as stop, ckpter, _synced_bn(model, world > 1):
        for epoch in range(start_epoch, num_epoch):
            tl = train_loader_fn()
            se = getattr(tl, "set_epoch", None)
            if se is not None:
                # a fresh shuffle/sampler draw per epoch, deterministic in
                # the absolute epoch, so a resume replays the same order
                se(epoch)
            epoch_step = 0
            tl_it = iter(tl)
            if epoch == start_epoch and resume_epoch_step:
                print(f"resume: fast-forwarding {resume_epoch_step} batches "
                      f"of epoch {epoch}", flush=True)
                tl_it = itertools.islice(tl_it, resume_epoch_step, None)
                epoch_step = resume_epoch_step
            for batch in device_prefetch(tl_it, device, device_fields=[0]):
                if stop.requested:
                    # persist at the step boundary and stop; the context
                    # manager joins the write before returning
                    print(f"preemption: signal {stop.signum} — checkpointing "
                          f"at step {global_step} and stopping", flush=True)
                    save(epoch, global_step, epoch_step)
                    return state
                if aug_rng is None:
                    images = normalize_batch(batch[0], out_size)
                else:
                    aug_rng.manual_seed(fold_seed(aug_seed, global_step))
                    images = augment_batch(aug_rng, batch[0], augment_cfg)
                state, metrics = step_fn(state, images,
                                         to_device(batch[1], target_dtype))
                # device tensors, read back at the eval cadence only
                train_metrics.append(metrics)

                if global_step % eval_per_iter == 0:
                    train_metrics = [{k: float(v) for k, v in m.items()}
                                     for m in train_metrics]
                    test_accum, counts = [], []
                    for x, t, w in _padded_eval_batches(test_loader_fn(),
                                                        counts):
                        m = eval_fn(model, normalize_batch(to_device(
                            x, torch.uint8), out_size),
                            to_device(t, target_dtype),
                            to_device(w, torch.float32))
                        test_accum.append(m)
                    if world > 1 and test_accum:
                        test_accum, counts = _over_ranks(test_accum, counts)
                    test_accum = [{k: float(v) for k, v in m.items()}
                                  for m in test_accum]
                    if not test_accum and not warned_empty_test:
                        warned_empty_test = True
                        print("warning: test loader yielded no batches "
                              "(test split smaller than the batch size with "
                              "drop_last?) — test metrics will be skipped",
                              flush=True)
                    if writer is not None:
                        # train: the plain mean over the cadence window;
                        # test: weighted by the real rows of each batch
                        scalars = {}
                        if train_metrics:
                            for k in train_metrics[0]:
                                scalars[f"{k}/train"] = float(
                                    np.mean([m[k] for m in train_metrics]))
                        if test_accum:
                            n_tot = float(sum(counts))
                            for k in test_accum[0]:
                                scalars[f"{k}/test"] = float(
                                    sum(m[k] * n for m, n in
                                        zip(test_accum, counts)) / n_tot)
                        writer.add_scalars(scalars, global_step)
                    train_metrics = []
                global_step += 1
                epoch_step += 1

            if epoch % save_per_epoch == 0:
                # epoch + 1: the first epoch a resume still has to run
                save(epoch + 1, global_step)
        # terminal save: the cadence misses the last num_epoch %
        # save_per_epoch epochs
        if global_step != saved_step:
            save(num_epoch, global_step)
    return state
