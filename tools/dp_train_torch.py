"""One rank of a data-, tensor- or spatially parallel training run of the
PyTorch port, for the tests and ``chip_smoke.py``: the GAN trainer
(``--mode gan``, ``--tensor_parallel T`` to split its networks over T
ranks; ``--spatial N`` instead runs the combined GAN step itself, each
image's rows cut over the N ranks of a data row, ``parallel/spatial.py``),
``train_supervised`` (``--mode sup``), the estimator CLI (``--mode cli``)
or the GAN estimator CLI (``--mode est_cli``) for a few steps on seeded
synthetic data, with what each rank saw written to ``--out``:

* ``rank{r}.json``: the world, the device, each step's metrics (the ranks'
  means), each step's wall ms and all-reduce ms with ``--timing`` (under
  tensor parallelism the model-group sums apart: their count and ms a
  step; under ``--spatial`` the exchanges of the data row likewise), and
  the K1/K2/K4 launches of the run (and of K1's split-statistics and K2's
  row-window forms), and the allocations the card refused (a refused cuDNN
  workspace runs another engine: ``_device.refused_allocations``);
* ``rank{r}.pt``: the rank's final train state as a checkpoint holds it
  (``train/checkpoint.py::serialize`` bytes);
* with ``--snapshots``, rank 0's state after each step k as
  ``rank0_s{k}.pt``, so that a reference can take step k from the state
  the ranks took it from (Adam's sign flips compound over steps taken
  apart); with ``--dump_inputs`` each rank's step inputs (images,
  targets) of the supervised modes as ``rank{r}_in{k}.pt``, which joined
  are step k's global batch, and of the GAN modes each rank's content
  images, labels, condition images and labels; with
  ``--dump_activations`` each rank's input of the generator's last
  decoder block (after the dropout) at its first forward,
  ``rank{r}_act.pt``;
* with ``--save_start``, rank 0's state as the trainer holds it once
  built (resumed), ``start.pt``.

``--save_every N`` makes the GAN trainer checkpoint every N steps;
``--stop_after K`` sends this rank SIGTERM after its step K, so the
trainer checkpoints at step K and stops (preemption).

Launched by ``parallel/launch.py`` it is one rank of the process group;
run plainly it is the one-process run the ranks are held to:

    python -m weather_unet_tpu_torch.parallel.launch -n 2 --cpu -- \\
        python tools/dp_train_torch.py --mode gan --out OUT --save_dir CP \\
        --device cpu --size 16 --batch 4 --steps 2

The trainers resume from ``--save_dir`` (``--name``): a run that starts
from given weights has them saved there at step 0 first.  TensorBoard is
not imported (the summaries fall back to JSONL), so a rank starts in
seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

EST_SEED = 5          # the linear stand-in estimator's weights
DATA_SEED = 11        # the synthetic images and targets


def est_weights() -> np.ndarray:
    return np.random.default_rng(EST_SEED).standard_normal(
        (3, 5)).astype(np.float32)


def linear_estimator(images: torch.Tensor) -> torch.Tensor:
    """A differentiable stand-in for the frozen estimator: the images'
    channel means through a seeded (3, 5) matrix (NCHW in)."""
    w = torch.from_numpy(est_weights()).to(images.device, images.dtype)
    return images.mean(dim=(2, 3)) @ w


class Synthetic:
    """n seeded uint8 NHWC images with an int class and 5 float signals."""

    def __init__(self, n: int, size: int, seed: int = DATA_SEED):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, size, size, 3), np.uint8)
        self.labels = rng.integers(0, 5, n)
        self.signals = rng.standard_normal((n, 5)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def get_class(self, i):
        return int(self.labels[i])


class GanItems(Synthetic):
    def __getitem__(self, i):
        return self.images[i], int(self.labels[i])


class SignalItems(Synthetic):
    def __getitem__(self, i):
        return self.images[i], self.signals[i]


def gan_loaders(args):
    """The content and random-condition loaders (one epoch = ``steps``
    batches), split by rank under a process group.  The random conditions
    come from images of their own: where a row's content and condition
    images are one image, ``loss_con`` divides that row's error by its
    eps alone (1e-7), and the step's gradient becomes that one row's, so
    sensitive that one rounding of the input moves ``g_loss`` by ~97%
    (measured on an H100 with the two loaders over one small set)."""
    from weather_unet_tpu_torch.data.pipeline import BatchLoader

    n = args.steps * args.batch
    ds = GanItems(n, args.size)
    rand = GanItems(n, args.size, seed=DATA_SEED + 2)
    return ((lambda: BatchLoader(ds, args.batch, shuffle=True, seed=0,
                                 num_workers=2, process_shard=True)),
            (lambda: BatchLoader(rand, args.batch, shuffle=True, seed=1,
                                 num_workers=2, process_shard=True)))


def sup_loaders(args):
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.parallel.launch import process_count

    train = SignalItems(args.steps * args.batch, args.size)
    test = SignalItems(args.batch, args.size, seed=DATA_SEED + 1)
    return ((lambda: BatchLoader(train, args.batch, shuffle=True, seed=0,
                                 num_workers=2, process_shard=True)),
            (lambda: BatchLoader(test, args.batch,
                                 drop_last=process_count() > 1,
                                 num_workers=2, process_shard=True)))


class Recorder:
    """Each step's metrics and, with ``timing``, its wall ms and the ms of
    its all-reduces (the device synchronized around each, so that the
    all-reduce's time is apart from the work queued before it); the
    model-group sums of a split model (``shards``, set once the trainer
    is built) are counted and timed on their own, and taken out of the
    all-reduce ms.
    With ``snap_dir`` every rank builds the checkpoint tree after each
    step (a split model gathers it over its model group) and rank 0
    writes it."""

    def __init__(self, device, timing: bool, snap_dir=None, dump_dir=None):
        self.device, self.timing, self.snap_dir = device, timing, snap_dir
        self.dump_dir = dump_dir
        self.tree_fn = None         # state -> checkpoint tree
        self.shards = None          # parallel/tp.py::Shards of a split model
        self.metrics, self.step_ms, self.allreduce_ms = [], [], []
        self.tp_sums, self.tp_sum_ms = [], []
        self._ar = 0.0
        if timing:
            inner = torch.distributed.all_reduce

            def timed(*a, **k):
                self._sync()
                t0 = time.perf_counter()
                out = inner(*a, **k)
                self._sync()
                self._ar += (time.perf_counter() - t0) * 1e3
                return out

            torch.distributed.all_reduce = timed


    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, step):
        def recorded(*a, **k):
            if self.dump_dir is not None:
                from weather_unet_tpu_torch.parallel.launch import (
                    process_index)

                torch.save(tuple(t.cpu() for t in a[1:5]
                                 if isinstance(t, torch.Tensor)),
                           os.path.join(self.dump_dir,
                                        f"rank{process_index()}_in"
                                        f"{len(self.metrics) + 1}.pt"))
            self._sync()
            g = self.shards
            sums0, sum_s0 = (g.sums, g.sum_s) if g is not None else (0, 0.0)
            self._ar, t0 = 0.0, time.perf_counter()
            out = step(*a, **k)
            self.metrics.append({n: float(v) for n, v in out[1].items()})
            self._sync()
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            tp_ms = 0.0
            if g is not None:
                tp_ms = (g.sum_s - sum_s0) * 1e3
                self.tp_sums.append(g.sums - sums0)
                self.tp_sum_ms.append(tp_ms)
            # the gradient all-reduces: every all-reduce but the sums'
            self.allreduce_ms.append(max(self._ar - tp_ms, 0.0))
            self.state = out[0]
            if self.snap_dir is not None:
                from weather_unet_tpu_torch.parallel.launch import (
                    process_index)

                tree = self.tree_fn(self.state)
                if process_index() == 0:
                    save_tree(os.path.join(self.snap_dir, f"rank0_s"
                                           f"{len(self.metrics)}.pt"), tree)
            return out

        for attr in ("program", "programs"):
            if hasattr(step, attr):
                setattr(recorded, attr, getattr(step, attr))
        return recorded


def save_tree(path: str, tree) -> None:
    from weather_unet_tpu_torch.train import checkpoint as ckpt

    with open(path, "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(tree)))


def watch_decoder(gen, out_dir):
    """Save this rank's input of ``gen.dconv_up1`` at its first forward."""
    from weather_unet_tpu_torch.parallel.launch import process_index

    def hook(module, inputs):
        if not getattr(hook, "done", False):
            hook.done = True
            torch.save(inputs[0].detach().cpu(), os.path.join(
                out_dir, f"rank{process_index()}_act.pt"))

    gen.dconv_up1.register_forward_pre_hook(hook)


def run_gan(args, device, dt, rec):
    from weather_unet_tpu_torch.parallel.mesh import make_mesh
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    kw = dict(input_size=args.size, batch_size=args.batch, lr=args.lr,
              num_epoch=1, dropout_rate=args.dropout, dtype=dt)
    if args.gan_mode == "cls":
        kw.update(mode="cls", cross_ent=True)
    if args.estimator_path:
        from weather_unet_tpu_torch.cli.common import load_step_estimator

        est = load_step_estimator(args.estimator_path, dtype=dt,
                                  device=device, route=args.route)
    else:
        est = linear_estimator
    tp = args.tensor_parallel > 1
    model = args.tensor_parallel if tp else args.model_axis
    plan = make_mesh(model=model, batch_size=args.batch) if (
        model > 1) else None
    tr = WeatherTransferTrainer(
        GanConfig(**kw), est, save_dir=args.save_dir, name=args.name,
        log_dir=os.path.join(args.out, "runs"), seed=args.seed,
        aot_cache=args.aot_cache, device=device, plan=plan,
        tensor_parallel=tp)
    rec.tree_fn = lambda state: ckpt.gan_tree(state, tr.seed)
    if tp:
        rec.shards = tr.gen.tp_layout.group
        rec.shards.timed = rec.timing
    if args.dump_activations:
        watch_decoder(tr.gen, args.out)
    if args.save_every:
        tr.EVAL_PER_STEP = args.save_every
    if args.save_start:
        from weather_unet_tpu_torch.parallel.launch import process_index

        tree = rec.tree_fn(tr.state)
        if process_index() == 0:
            save_tree(os.path.join(args.out, "start.pt"), tree)
    tr._step = rec.wrap(tr._step)
    if args.stop_after:
        import signal

        step = tr._step

        def stopping(*a, **k):
            out = step(*a, **k)
            if len(rec.metrics) == args.stop_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        stopping.programs = step.programs
        tr._step = stopping
    tl, rl = gan_loaders(args)
    tr.fit(tl, rl)
    return ckpt.gan_tree(tr.state, tr.seed)


def run_spatial(args, device, dt, rec):
    """``--spatial N``: the combined GAN step (``train/gan.py``) on this
    rank's rows of its data row's images, ``steps`` steps over the seeded
    synthetic sets in order (step k takes global rows ``[k B, (k + 1) B)``
    of each), the dropout generator of step k seeded ``fold_seed(seed +
    1, k)`` (folded with the data index over several data rows), from
    ``--init`` (a checkpoint file) or the seeded initial state."""
    from weather_unet_tpu_torch.core.rng import fold_seed
    from weather_unet_tpu_torch.data.transforms import normalize_batch
    from weather_unet_tpu_torch.parallel import spatial
    from weather_unet_tpu_torch.parallel.launch import (
        data_count, data_index, process_slice)
    from weather_unet_tpu_torch.parallel.mesh import (
        make_mesh, put_host_local)
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train.gan import (
        GanConfig, build_gan_state, make_gan_step)

    plan = make_mesh(model=args.spatial, batch_size=args.batch)
    sharding = plan.spatial(input_size=args.size)
    group = spatial.process_group(args.size)
    kw = dict(input_size=args.size, batch_size=args.batch, lr=args.lr,
              num_epoch=1, dropout_rate=args.dropout, dtype=dt)
    if args.gan_mode == "cls":
        kw.update(mode="cls", cross_ent=True)
    cfg = GanConfig(**kw)
    gen, disc, state = build_gan_state(cfg, args.seed, device,
                                       use_pallas=device.type == "cuda")
    if args.init:
        ckpt.restore_checkpoint(args.init, state)
    spatial.spatial_(gen, group)
    spatial.spatial_(disc, group)
    if args.estimator_path:
        from weather_unet_tpu_torch.cli.common import load_step_estimator

        est = load_step_estimator(args.estimator_path, dtype=dt,
                                  device=device, route=args.route)
    else:
        est = linear_estimator
    rec.tree_fn = lambda st: ckpt.gan_tree(st, args.seed)
    rec.shards = group.shards
    rec.shards.timed = rec.timing
    if args.dump_activations:
        watch_decoder(gen, args.out)
    step = rec.wrap(make_gan_step(gen, disc, est, cfg))
    n = args.steps * args.batch
    sets = [GanItems(n, args.size), GanItems(n, args.size,
                                             seed=DATA_SEED + 2)]
    mine = process_slice(args.batch)
    base = (args.seed + 1 if data_count() == 1
            else fold_seed(args.seed + 1, data_index()))
    g = torch.Generator(device=device)
    for k in range(1, args.steps + 1):
        rows = slice((k - 1) * args.batch, k * args.batch)
        x, r = (put_host_local(sharding, ds.images[rows][mine])
                for ds in sets)
        labels = [torch.as_tensor(ds.labels[rows][mine]).to(device)
                  for ds in sets]
        g.manual_seed(fold_seed(base, k))
        state, _ = step(state, normalize_batch(x).to(device), labels[0],
                        normalize_batch(r).to(device), labels[1], g,
                        do_g=True)
    return ckpt.gan_tree(state, args.seed)


def run_sup(args, device, dt, rec):
    from weather_unet_tpu_torch.models import ResNet
    from weather_unet_tpu_torch.parallel.mesh import make_mesh
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import supervised as sup
    from weather_unet_tpu_torch.train.loops import train_supervised

    model = ResNet(tuple(args.counts), 5, dtype=dt,
                   param_dtype=torch.float32,
                   generator=torch.Generator().manual_seed(args.seed))
    state = sup.build_supervised_state(model.to(device), args.lr, args.wd)
    tl, te = sup_loaders(args)
    rec.tree_fn = lambda st: ckpt.supervised_tree(st, 0, st.step)
    state = train_supervised(
        rec.wrap(sup.make_estimator_step()), sup.make_eval_metrics(
            "estimator"), tl, te, state=state, num_epoch=1,
        input_size=args.size, save_dir=args.save_dir, name=args.name,
        eval_per_iter=1000, batch_size=args.batch, aot_cache=args.aot_cache,
        plan=make_mesh(model=args.model_axis, batch_size=args.batch)
        if args.model_axis > 1 else None)
    return ckpt.supervised_tree(state, 1, args.steps)


def run_cli(args, rec):
    """``cli/train_estimator.py::main(args.cli_args)`` with its steps
    recorded; the state as its last step left it."""
    from weather_unet_tpu_torch.cli import train_estimator
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import supervised as sup

    make = sup.make_estimator_step
    rec.tree_fn = lambda st: ckpt.supervised_tree(st, 0, st.step)
    sup.make_estimator_step = lambda: rec.wrap(make())
    try:
        train_estimator.main(args.cli_args)
    finally:
        sup.make_estimator_step = make
    return ckpt.supervised_tree(rec.state, 1, len(rec.metrics))


def run_est_cli(args, rec):
    """``cli/train_transfer_est.py::main(args.cli_args)`` with its GAN steps
    recorded (and its estimator's route forced with ``--route``); the
    state as its last step left it."""
    from weather_unet_tpu_torch.cli import common, train_transfer_est
    from weather_unet_tpu_torch.train import checkpoint as ckpt
    from weather_unet_tpu_torch.train import loops

    if args.route is not None:
        load = common.load_step_estimator
        common.load_step_estimator = lambda *a, **k: load(
            *a, **{**k, "route": args.route})
    make = loops.make_gan_step
    rec.tree_fn = lambda st: ckpt.gan_tree(st, 0)

    def recorded(gen, *a, **k):
        layout = getattr(gen, "tp_layout", None)
        if layout is not None:
            rec.shards = layout.group
            rec.shards.timed = rec.timing
        return rec.wrap(make(gen, *a, **k))

    loops.make_gan_step = recorded
    try:
        train_transfer_est.main(args.cli_args)
    finally:
        loops.make_gan_step = make
    return ckpt.gan_tree(rec.state, 0)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", choices=["gan", "sup", "cli", "est_cli"],
                   required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--name", default="run")
    p.add_argument("--device", default=None)
    p.add_argument("--gan_mode", choices=["est", "cls"], default="est")
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--batch", type=int, default=4, help="the global batch")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--wd", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--counts", type=int, nargs=4, default=[1, 1, 1, 1])
    p.add_argument("--estimator_path", default=None)
    p.add_argument("--route", choices=["k4", "plain"], default=None)
    p.add_argument("--aot_cache", default=None)
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="--mode gan: split the networks over T ranks")
    p.add_argument("--spatial", type=int, default=1,
                   help="--mode gan: cut each image's rows over N ranks "
                        "of a data row (the combined step, not the "
                        "trainer)")
    p.add_argument("--init", default=None,
                   help="--spatial: the start state (a checkpoint file)")
    p.add_argument("--model_axis", type=int, default=1,
                   help="--mode gan / sup: a plan with a model axis of M "
                        "and no tensor parallelism (replicas)")
    p.add_argument("--dump_activations", action="store_true",
                   help="--mode gan: each rank writes its last decoder "
                        "block's input at the first forward")
    p.add_argument("--save_every", type=int, default=0,
                   help="--mode gan: checkpoint every N steps")
    p.add_argument("--stop_after", type=int, default=0,
                   help="--mode gan: SIGTERM this rank after step K")
    p.add_argument("--save_start", action="store_true",
                   help="--mode gan: rank 0 writes the built (resumed) "
                        "state as start.pt")
    p.add_argument("--timing", action="store_true")
    p.add_argument("--snapshots", action="store_true",
                   help="rank 0 writes its state after each step")
    p.add_argument("--dump_inputs", action="store_true",
                   help="each rank writes its supervised step inputs")
    p.add_argument("--deterministic", action="store_true",
                   help="cuDNN's deterministic algorithms, TF32 off")
    p.add_argument("cli_args", nargs=argparse.REMAINDER,
                   help="--mode cli / est_cli: the CLI's arguments "
                        "after --")
    return p


def main(argv=None) -> int:
    sys.modules.setdefault("torch.utils.tensorboard", None)  # JSONL
    args = build_parser().parse_args(argv)
    if args.cli_args and args.cli_args[0] == "--":
        args.cli_args = args.cli_args[1:]
    from weather_unet_tpu_torch._device import (
        refused_allocations, resolve_device)
    from weather_unet_tpu_torch.kernels import adain, bottleneck, upsample
    from weather_unet_tpu_torch.parallel.launch import (
        maybe_initialize, process_count, process_index)
    from weather_unet_tpu_torch.train import checkpoint as ckpt

    maybe_initialize()
    if args.deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    kernels = {"adain": adain, "upsample": upsample,
               "bottleneck": bottleneck}
    for m in kernels.values():
        m.launches = 0
    split = {"adain_stats": (adain, "stats_launches"),
             "adain_apply": (adain, "apply_launches"),
             "upsample_rows": (upsample, "rows_launches")}
    for m, attr in split.values():
        setattr(m, attr, 0)
    os.makedirs(args.out, exist_ok=True)
    rec = Recorder(device, args.timing,
                   args.out if args.snapshots else None,
                   args.out if args.dump_inputs else None)
    t0 = time.perf_counter()
    if args.mode == "gan" and args.spatial > 1:
        tree = run_spatial(args, device, dt, rec)
    elif args.mode == "gan":
        tree = run_gan(args, device, dt, rec)
    elif args.mode == "sup":
        tree = run_sup(args, device, dt, rec)
    elif args.mode == "cli":
        tree = run_cli(args, rec)
    else:
        tree = run_est_cli(args, rec)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rank = process_index()
    save_tree(os.path.join(args.out, f"rank{rank}.pt"), tree)
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": process_count(),
                   "device": str(device),
                   "seconds": time.perf_counter() - t0,
                   "metrics": rec.metrics, "step_ms": rec.step_ms,
                   "allreduce_ms": rec.allreduce_ms,
                   "tp_sums": rec.tp_sums, "tp_sum_ms": rec.tp_sum_ms,
                   "launches": {k: m.launches
                                for k, m in kernels.items()},
                   "split_launches": {k: getattr(m, attr) for k, (m, attr)
                                      in split.items()},
                   "refused_allocations": refused_allocations(device)}, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
