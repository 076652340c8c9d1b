"""The port's AOT tier (``weather_unet_tpu_torch/core/aot.py``) on the CPU,
against the JAX package's (``weather_unet_tpu/core/aot.py``) where a
counterpart exists, mirroring ``tests/test_aot.py``: one program per shape;
``WeatherTransfer(aot_cache=)`` and ``serve --aot_cache``; the GAN trainer
and ``train_supervised`` with the tier; restores into the state a graph
would hold, from the port's checkpoints and the JAX package's layout; no
use of the tier writes or reads a program file; one capture at a time.

On the CPU there is no CUDA graph: the per-shape programs run as on the
card, and the port with the tier equals the port without it bit for bit.  Against the JAX package (on one CPU device): serving
``translate`` MAE < 1e-5 and ``translate_u8`` within 1 uint8 step; the
trainers at the bars of ``tests/test_torch_gan.py`` and
``tests/test_torch_supervised.py`` (losses rtol 2e-4, the Adam sign-flip
bound, u 1e-4, BatchNorm statistics 1e-5).
"""

import os
import shutil
import sys
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_gan import (
    assert_adam_close, jax_sds, load_jax_state, port_sds)
from tests.test_torch_supervised import (
    Batches, assert_states_close, jax_state, port_state, state_equal)
from tests.test_torch_train_cli import data  # noqa: F401  (the fixture)
from tests.test_torch_trainer import (
    W_EST, Images, assert_states_equal, cfg_of, est_apply, loaders, trainer)
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu.core import aot as jax_aot
from weather_unet_tpu.parallel.mesh import make_mesh
from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.cli import serve
from weather_unet_tpu_torch.core import aot
from weather_unet_tpu_torch.core.aot import AotCache, AotJit
from weather_unet_tpu_torch.data.pipeline import BatchLoader
from weather_unet_tpu_torch.data.transforms import normalize_batch
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train import supervised as sup
from weather_unet_tpu_torch.train.gan import GanConfig
from weather_unet_tpu_torch.train.loops import (
    WeatherTransferTrainer, train_supervised)

LR = 1e-4


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    """Delete what a test wrote once it ends: its checkpoints and weight
    files are ~0.1-0.5 GB each, and pytest keeps every test's directory
    until the run ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _fn(w, x):
    return torch.tanh(x @ w) * 2.0


def _jfn(w, x):
    return jnp.tanh(x @ w) * 2.0


def test_aotjit_one_program_per_shape_and_bounded_memo(tmp_path):
    """One program per shape and dtype, as ``jax.jit``'s cache keeps
    one executable each; ``reset`` drops them.  No memo of argument
    identities is kept: the key is the arguments' shapes, read per call."""
    cache = AotCache(str(tmp_path))
    aj = AotJit(_fn, cache)
    w = torch.ones(8, 8)
    aj(w, torch.ones(1, 8))
    aj(w, torch.ones(2, 8))
    aj(w, torch.ones(2, 8))       # same shape: the same program
    aj(w.double(), torch.ones(2, 8, dtype=torch.float64))
    assert aj._cache_size() == 3 and cache.stats == {
        "programs": 3, "captures": 0, "capture_s": 0.0}
    assert torch.equal(aj(w, torch.ones(2, 8)), _fn(w, torch.ones(2, 8)))
    jexe = jax.jit(_jfn)
    x = np.arange(16, dtype=np.float32).reshape(2, 8) / 16.0
    np.testing.assert_allclose(aj(w, torch.from_numpy(x)).numpy(),
                               np.asarray(jexe(np.ones((8, 8), np.float32),
                                               x)), rtol=1e-6)
    aj.reset()
    assert aj._cache_size() == 0 and not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("entry_points", [1, 2])
def test_captures_of_one_cache_take_turns(monkeypatch, entry_points):
    """Threads reach new shapes at once, through one entry point or
    through two that share an ``AotCache`` (a ``WeatherTransfer``'s
    ``translate`` and ``translate_u8``): their warm-ups and captures, which
    run on the cache's one side stream, never overlap, and each shape is
    captured once.  The capture is stood in for here (there is no CUDA
    graph on the CPU), and the check is of the cache's turn-taking around
    it; more threads than cores, with a short switch interval."""
    inside, seen, lock = [0], [], threading.Lock()

    class Capture:
        def __init__(self, fn, args, inplace, stream):
            with lock:
                inside[0] += 1
                seen.append(inside[0])
            time.sleep(0.02)
            with lock:
                inside[0] -= 1
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    monkeypatch.setattr(aot, "_Graphed", Capture)
    monkeypatch.setattr(aot, "_device_of", lambda args: torch.device("cuda"))
    monkeypatch.setattr(AotCache, "_stream", lambda self, device: None)
    cache = AotCache("unused")
    jits = [AotJit(_fn, cache) for _ in range(entry_points)]
    w = torch.ones(8, 8)
    errors = []

    def calls(t):
        try:
            for n in range(1, 5):
                x = torch.full((n, 8), float(t))
                assert torch.equal(jits[t % entry_points](w, x), _fn(w, x))
        except Exception as e:      # noqa: BLE001  (re-raised below)
            errors.append(e)

    threads = [threading.Thread(target=calls, args=(t,))
               for t in range(2 * (os.cpu_count() or 2))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert max(seen) == 1
    assert cache.stats["captures"] == 4 * entry_points == len(seen)


@pytest.fixture(scope="module")
def gan_cp(tmp_path_factory):
    """A JAX-initialized cUNet as a reference ``.pt`` bundle (32x32)."""
    from weather_unet_tpu.train import checkpoint as jax_ckpt
    from weather_unet_tpu.train.gan import GanConfig as JaxGanConfig
    from weather_unet_tpu.train.gan import build_gan_state

    _, _, state = build_gan_state(JaxGanConfig(input_size=32),
                                  jax.random.key(0))
    path = str(tmp_path_factory.mktemp("aot") / "g.pt")
    jax_ckpt.export_torch_gan(path, {"params": state.gen.params},
                              {"params": state.disc.params,
                               "spectral": state.spectral}, 0, 0)
    return path


def test_api_aot_equals_plain_and_jax(gan_cp, tmp_path):
    """``WeatherTransfer(aot_cache=)`` on the CPU: every entry point bit-equal
    to the port without the tier; against the JAX tier on the same weights,
    translate MAE < 1e-5 and translate_u8 within 1 step; a restart on the
    same directory computes the same and writes and reads no file."""
    from weather_unet_tpu.api import WeatherTransfer as JaxTransfer

    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (3, 32, 32, 3), np.uint8)
    conds = np.eye(5, dtype=np.float32)[[0, 2, 4]]
    x = WeatherTransfer.preprocess(u8).numpy()
    cdir = tmp_path / "port"
    plain = WeatherTransfer.load(gan_cp, device="cpu")
    tier = WeatherTransfer.load(gan_cp, device="cpu", aot_cache=str(cdir))
    got_u8 = tier.translate_u8(u8, conds)
    got = tier.translate(x, conds)
    assert torch.equal(got_u8, plain.translate_u8(u8, conds))
    assert torch.equal(got, plain.translate(x, conds))
    assert torch.equal(tier.translate_to_classes(x[:2]),
                       plain.translate_to_classes(x[:2]))
    assert tier._translate_u8._cache_size() == 1       # the bucket of 4
    assert tier.aot.stats["programs"] == 3

    jt = JaxTransfer.load(gan_cp, aot_cache=str(tmp_path / "jax"))
    want = np.asarray(jt.translate(x, conds))
    assert float(np.abs(got.numpy() - want).mean()) < 1e-5
    want_u8 = np.asarray(jt.translate_u8(u8, conds)).astype(int)
    assert np.abs(got_u8.numpy().astype(int) - want_u8).max() <= 1

    again = WeatherTransfer.load(gan_cp, device="cpu", aot_cache=str(cdir))
    assert torch.equal(again.translate_u8(u8, conds), got_u8)
    assert again.aot.stats["programs"] == 1 and not cdir.exists()


def test_serve_aot_flag(gan_cp, tmp_path):
    """``serve --aot_cache``: warm-up makes one program for each of the
    buckets 1, 2 and 4; a restart makes them again and neither start
    writes a file; ``--artifact`` still refuses the flag."""
    cdir = tmp_path / "srv"
    argv = ["--cp_path", gan_cp, "--host", "127.0.0.1", "--port", "0",
            "--input_size", "32", "--max_batch", "4", "--aot_cache",
            str(cdir), "--device", "cpu"]
    for _ in range(2):
        server = serve.build_server(serve.build_parser().parse_args(argv))
        try:
            assert server.transfer._translate_u8._cache_size() == 3
            assert server.transfer.aot.stats == {
                "programs": 3, "captures": 0, "capture_s": 0.0}
        finally:
            server.server_close()
        assert not cdir.exists()
    with pytest.raises(SystemExit, match="--aot_cache does not apply"):
        serve.build_server(serve.build_parser().parse_args(
            ["--artifact", str(tmp_path), "--aot_cache", str(cdir),
             "--no-warmup", "--device", "cpu"]))


@pytest.fixture
def no_program_files(monkeypatch):
    """Fail a test that exports, saves or loads a program: the tier keeps
    nothing on disk."""
    def refuse(*args, **kwargs):
        raise AssertionError("the AOT tier touched a program file")

    for name in ("export", "save", "load"):
        monkeypatch.setattr(torch.export, name, refuse)


def test_graphed_serving_reads_the_weights_where_they_lie(gan_cp, tmp_path,
                                                          no_program_files):
    """The tier's program reads the model's weights by closure: after a
    ``load_state_dict`` into the same model the same bucket's program
    computes with the new weights, equal to a plain transfer of them."""
    u8 = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), np.uint8)
    conds = np.eye(5, dtype=np.float32)[[1, 3]]
    tier = WeatherTransfer.load(gan_cp, device="cpu",
                                aot_cache=str(tmp_path / "aot"))
    before = tier.translate_u8(u8, conds)
    sd = {k: v * 0.5 if k.endswith("weight") else v
          for k, v in tier.model.state_dict().items()}
    tier.model.load_state_dict(sd)
    after = tier.translate_u8(u8, conds)
    assert tier._translate_u8._cache_size() == 1 and not torch.equal(
        before, after)
    plain = WeatherTransfer.load(gan_cp, device="cpu")
    plain.model.load_state_dict(sd)
    assert torch.equal(after, plain.translate_u8(u8, conds))


def _jax_layout_run(tmp_path, subs, tree):
    """The same JAX-layout checkpoint (``tree``, a ``*_tree_to_jax``) in
    the run directory ``<sub>/g`` of each of ``subs``."""
    for sub in subs:
        ckpt.save_checkpoint_file(str(
            tmp_path / sub / "g" / f"ckpt_s{tree['global_step']:010d}"
            ".msgpack"), tree)


@pytest.mark.parametrize("use", ["serving", "gan_trainer", "supervised",
                                 "restored_trainer"])
def test_the_tier_writes_and_reads_no_program(tmp_path, gan_cp, use,
                                              no_program_files):
    """Uses of the tier that the tests above leave out, each bit-equal to
    the same use without it, and none exporting, saving or loading a
    program or making its directory: serving at every batch from 1 to 5
    (buckets 1, 2, 4, 8); the GAN trainer in cls mode; and the supervised
    loop and the GAN trainer resumed from a JAX-layout checkpoint
    (``train/checkpoint.py``'s ``*_tree_to_jax``), which reset the
    programs after the load."""
    cdir = tmp_path / "aot"
    if use == "serving":
        plain = WeatherTransfer.load(gan_cp, device="cpu")
        tier = WeatherTransfer.load(gan_cp, device="cpu", aot_cache=str(cdir))
        rng = np.random.default_rng(5)
        for b in range(1, 6):
            u8 = rng.integers(0, 256, (b, 32, 32, 3), np.uint8)
            conds = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
            x = WeatherTransfer.preprocess(u8).numpy()
            assert torch.equal(tier.translate_u8(u8, conds),
                               plain.translate_u8(u8, conds)), b
            assert torch.equal(tier.translate(x, conds),
                               plain.translate(x, conds)), b
        assert tier._translate_u8._cache_size() == 4
        assert tier.aot.stats["programs"] == 8
    elif use == "supervised":
        from tests.test_torch_resnet import jax_resnet_variables

        _, variables = jax_resnet_variables((1, 1, 1, 1), 5, 32)

        def run(sub, num_epoch, **kw):
            state = port_state(variables, "classifier")
            train_supervised(
                sup.make_classifier_step(),
                sup.make_eval_metrics("classifier"), lambda: Batches(3),
                lambda: [], state=state, num_epoch=num_epoch, input_size=32,
                save_dir=str(tmp_path / sub), name="g", eval_per_iter=100,
                target_dtype=torch.long, **kw)
            return state

        first = run("first", 1)
        _jax_layout_run(tmp_path, ("eager", "tier"), ckpt.supervised_tree_to_jax(
            first, epoch=1, global_step=3, epoch_step=0))
        eager = run("eager", 2)
        tier = run("tier", 2, aot_cache=str(cdir))
        assert tier.step == eager.step == 6 and state_equal(tier, eager)
    else:
        data = Images(4)
        if use == "gan_trainer":
            cfg = cfg_of(num_epoch=1, batch_size=2, mode="cls")
            eager = trainer(tmp_path, cfg, "eager")
        else:
            cfg = cfg_of(num_epoch=2, batch_size=2)
            first = trainer(tmp_path, cfg_of(num_epoch=1, batch_size=2),
                            "first")
            first.fit(*loaders(data))
            _jax_layout_run(tmp_path, ("eager", "tier"),
                            ckpt.gan_tree_to_jax(first.state))
            eager = trainer(tmp_path, cfg, "eager")
        tier = trainer(tmp_path, cfg, "tier", aot_cache=str(cdir))
        assert tier.state.global_step == eager.state.global_step
        for tr in (eager, tier):
            tr.fit(*loaders(data))
        assert tier.state.global_step == eager.state.global_step
        assert tier.state.global_step == (2 if use == "gan_trainer" else 4)
        assert tier.aot.stats["programs"] == 1
        assert_states_equal(tier.state, eager.state)
    assert not cdir.exists()


def test_trainer_aot_cache_equals_eager(tmp_path):
    """The GAN trainer with the tier, 32x32, batch 4, dropout 0.3,
    ``gd_train_ratio=2`` (both programs run): ``fit`` equals the trainer
    without it bit for bit; one program each for D-only and D+G."""
    cfg = cfg_of(batch_size=4, gd_train_ratio=2)
    data = Images(9)

    def train():
        return BatchLoader(data, 4, shuffle=True, num_workers=2)

    def rand():
        return BatchLoader(data, 4, shuffle=True, seed=1, num_workers=2)

    eager = trainer(tmp_path, cfg, "eager")
    eager.fit(train, rand)
    tier = trainer(tmp_path, cfg, "tier", aot_cache=str(tmp_path / "aot"))
    assert isinstance(tier.aot, AotCache)
    tier.fit(train, rand)
    assert tier.state.global_step == eager.state.global_step == 4
    assert_states_equal(tier.state, eager.state)
    programs = tier._step.programs
    assert programs[True]._cache_size() == programs[False]._cache_size() == 1
    assert tier.aot.stats == {"programs": 2, "captures": 0,
                              "capture_s": 0.0}


def test_trainer_aot_cache_agrees_with_jax(tmp_path):
    """Both step programs of the port's tiered trainer against the JAX
    trainer's AOT-tier programs (one CPU device), from JAX's init and the
    same uint8 batches, dropout 0: the D-only step, then (after taking
    JAX's state, as tests/test_torch_gan.py does) the D+G step."""
    from weather_unet_tpu.train.gan import GanConfig as JaxGanConfig
    from weather_unet_tpu.train.loops import (
        WeatherTransferTrainer as JaxTrainer)

    kw = dict(input_size=32, batch_size=4, dropout_rate=0.0, lr=LR,
              gd_train_ratio=2, num_epoch=1)
    w_est = W_EST.numpy()

    def jest(images):
        return jnp.mean(images, axis=(1, 2)) @ jnp.asarray(w_est)

    jtr = JaxTrainer(JaxGanConfig(**kw), jest, save_dir=str(tmp_path / "j"),
                     name="g", log_dir=str(tmp_path / "runs"),
                     plan=make_mesh(jax.devices()[:1]),
                     aot_cache=str(tmp_path / "jaot"))
    tr = WeatherTransferTrainer(GanConfig(**kw), est_apply,
                                save_dir=str(tmp_path / "p"), name="g",
                                log_dir=str(tmp_path / "runs"),
                                device="cpu", aot_cache=str(tmp_path / "p"))
    try:
        _two_steps_against_jax(jtr, tr)
    finally:
        jtr.writer.close()
    assert jtr.aot.stats["misses"] == 2          # JAX: one per program
    programs = tr._step.programs
    assert programs[True]._cache_size() == programs[False]._cache_size() == 1
    assert (tr.state.global_step, tr.state.gen.step,
            tr.state.disc.step) == (2, 1, 2)


def _two_steps_against_jax(jtr, tr):
    rng = np.random.default_rng(21)
    jzeros = np.zeros(4, np.int32)
    zeros = torch.zeros(4, dtype=torch.long)
    for i, do_g in ((1, False), (2, True)):
        load_jax_state(tr.state, jtr.state)
        x, r = (rng.integers(0, 256, (4, 32, 32, 3), np.uint8)
                for _ in range(2))
        fn = jtr._step_dg if do_g else jtr._step_d
        jtr.state, jm = fn(jtr.state, x, jzeros, r, jzeros, jtr._base_key,
                           np.uint32(i))
        tr.state, m = tr._step(tr.state, normalize_batch(torch.from_numpy(x),
                                                         32), zeros,
                               normalize_batch(torch.from_numpy(r), 32),
                               zeros, tr._step_rng, do_g=do_g)
        assert set(m) == set(jm)
        for k in jm:
            # atol: g_loss_adv is a mean of D logits of order 1 that cancel
            # to ~1e-2, taken after D's update in the same step, whose
            # sign-flip elements (assert_adam_close) move a logit by ~1e-6
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       atol=1e-5, err_msg=f"{k} step {i}")
        got, want = port_sds(tr.gen, tr.disc), jax_sds(jtr.state)
        for g_sd, w_sd, what in zip(got, want, ("gen", "disc")):
            names = sorted(k for k in g_sd
                           if not k.endswith(("weight_u", "weight_v")))
            assert_adam_close(
                np.concatenate([g_sd[k].ravel() for k in names]),
                np.concatenate([np.asarray(w_sd[k]).ravel()
                                for k in names]), LR, i, f"{what} {i}")
        for k in got[1]:
            if k.endswith("weight_u"):
                np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-4,
                                           err_msg=f"u {k} step {i}")


def test_train_supervised_aot_cache(tmp_path):
    """``train_supervised(aot_cache=)``: bit-equal to the loop without the
    tier over 2 epochs; one step against JAX's ``train_supervised`` with its
    AOT tier (one CPU device) at tests/test_torch_supervised.py's bars."""
    from weather_unet_tpu.train import loops as jax_loops
    from weather_unet_tpu.train import supervised as jax_sup
    from tests.test_torch_resnet import jax_resnet_variables

    model, variables = jax_resnet_variables((1, 1, 1, 1), 5, 32)

    def port_run(name, n, num_epoch, **kw):
        state = port_state(variables, "classifier")
        train_supervised(
            sup.make_classifier_step(), sup.make_eval_metrics("classifier"),
            lambda: Batches(n), lambda: Batches(1, b=3, seed=9),
            state=state, num_epoch=num_epoch, input_size=32,
            save_dir=str(tmp_path), name=name, eval_per_iter=2,
            target_dtype=torch.long, **kw)
        return state

    eager = port_run("eager", 3, 2)
    tier = port_run("tier", 3, 2, aot_cache=str(tmp_path / "aot"))
    assert state_equal(tier, eager) and tier.step == 6

    ported = port_run("one", 1, 1, aot_cache=str(tmp_path / "aot"))
    js = jax_loops.train_supervised(
        model, jax_sup.make_classifier_step(model),
        jax_sup.make_eval_metrics(model, "classifier"),
        lambda: Batches(1), lambda: Batches(1, b=3, seed=9),
        state=jax_state(variables, "classifier"),
        plan=make_mesh(jax.devices()[:1]), num_epoch=1,
        save_dir=str(tmp_path / "j"), name="one", eval_per_iter=100,
        target_dtype=jnp.int32, input_size=32,
        aot_cache=str(tmp_path / "jaot"))
    assert_states_close(ported, js, 1, "train_supervised")


@pytest.mark.parametrize("order", ["tier_then_eager", "eager_then_tier"])
def test_checkpoint_resumes_across_the_tier(tmp_path, order):
    """A run stopped after epoch 1 and resumed by a trainer on the other
    side of the tier ends equal to an uninterrupted run bit for bit."""
    cfg = cfg_of(num_epoch=2)
    data = Images(9)
    whole = trainer(tmp_path, cfg, "whole")
    whole.fit(*loaders(data))
    first, second = (({"aot_cache": str(tmp_path / "aot")}, {})
                     if order == "tier_then_eager"
                     else ({}, {"aot_cache": str(tmp_path / "aot")}))
    cut = trainer(tmp_path, cfg_of(num_epoch=1), "cut", **first)
    cut.fit(*loaders(data))
    resumed = trainer(tmp_path, cfg, "cut", **second)
    assert resumed.state.global_step == 4
    resumed.fit(*loaders(data))
    assert_states_equal(resumed.state, whole.state)


def test_nan_guard_rollback_with_the_tier(tmp_path, capsys):
    """The estimator turns NaN for the 4th batch: the tiered trainer rolls
    back to the step-2 checkpoint (its programs reset and take the
    restored state) and ends finite, one rollback."""
    poison = {"on": False}

    def est(images):
        out = est_apply(images)
        return out * float("nan") if poison["on"] else out

    data = Images(12)
    tr = WeatherTransferTrainer(cfg_of(num_epoch=1), est,
                                save_dir=str(tmp_path), name="g",
                                log_dir=str(tmp_path / "runs"), device="cpu",
                                nan_guard=True,
                                aot_cache=str(tmp_path / "aot"))
    tr.EVAL_PER_STEP, tr.DISPLAY_PER_STEP = 2, 1000
    train, rand = loaders(data)

    class Poisoning:
        def __init__(self, loader):
            self.loader, self.drop_last = loader, loader.drop_last

        def __len__(self):
            return len(self.loader)

        def set_epoch(self, epoch):
            self.loader.set_epoch(epoch)

        def __iter__(self):
            for i, batch in enumerate(self.loader):
                poison["on"] = i == 3
                yield batch

    tr.fit(lambda: Poisoning(train()), rand)
    out = capsys.readouterr().out
    assert "nan_guard: non-finite metrics" in out and "retry 1/3" in out
    assert tr._rollbacks == 1 and tr.state.global_step == 4
    assert not tr._nonfinite_metrics()
    assert all(torch.isfinite(p).all() for p in tr.gen.parameters())
    assert os.path.basename(ckpt.latest_checkpoint(str(tmp_path), "g")) == (
        "ckpt_s0000000004.pt")


@pytest.mark.parametrize("cli", ["transfer_est", "transfer_cls",
                                 "estimator", "classifier"])
def test_training_clis_take_aot_cache(data, tmp_path, cli,  # noqa: F811
                                      capsys):
    """The four training CLIs pass ``--aot_cache`` to their trainer (no
    longer refused): one epoch at 32x32, batch 2, on the CPU, to the
    terminal checkpoint; a training step keeps nothing on disk."""
    from weather_unet_tpu_torch.cli import (
        train_classifier, train_estimator, train_transfer_cls,
        train_transfer_est)

    root, flickr = data["root"], data["flickr"]
    aot_dir = tmp_path / "aot"
    gan = ["--estimator_path", data["est"], "--batch_size", "2",
           "--save_dir", str(tmp_path / "cp")]
    sup_ = ["-bs", "2", "--save_path", str(tmp_path / "cp")]
    main, args = {
        "transfer_est": (train_transfer_est.main,
                         ["--image_root", flickr, "--image_only"] + gan),
        "transfer_cls": (train_transfer_cls.main,
                         ["--image_root", flickr, "--image_only"] + gan),
        "estimator": (train_estimator.main,
                      ["--image_root", flickr, "--pkl_path",
                       str(root / "frame.pkl")] + sup_),
        "classifier": (train_classifier.main,
                       ["--pkl_path", str(root / "i2w.pkl")] + sup_),
    }[cli]
    main(args + ["--device", "cpu", "--input_size", "32", "--num_epoch", "1",
                 "--num_workers", "2", "--log_dir", str(tmp_path / "runs"),
                 "--name", "run", "--aot_cache", str(aot_dir)])
    assert "Done: training" in capsys.readouterr().out
    tree = torch.load(ckpt.latest_checkpoint(str(tmp_path / "cp"), "run"),
                      weights_only=True)
    assert tree["global_step"] == 4
    assert not aot_dir.exists()
