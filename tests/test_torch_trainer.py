"""The port's GAN trainer (``train/loops.py``), checkpoints
(``train/checkpoint.py``) and preemption handling on the CPU, at 32x32,
batch 2, the full-width cUNet and SNDisc, dropout 0.3, a linear estimator
head: ``fit`` equals a hand loop of ``make_gan_step`` bit for bit; a run
stopped by SIGTERM from inside its loader checkpoints at the stop step, and
a new trainer resumes, fast-forwards and ends bit-equal to the run that was
not interrupted; the terminal save, the evaluation and the summaries run; a
``nan_guard`` rollback happens; a restored checkpoint equals the saved state
bit for bit; ``export_torch_gan``'s bundle has the keys and values of the
JAX package's for the same weights (through the converters; the spectral
norm's derived ``weight`` and ``weight_v`` within float32 rounding)."""

import glob
import os
import signal

import numpy as np
import jax
import pytest
import torch

from tests.test_torch_gan import load_jax_state
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, no_thread_left, one_torch_thread)
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu.train import metrics as jax_metrics
from weather_unet_tpu_torch.core.rng import fold_seed
from weather_unet_tpu_torch.data.pipeline import BatchLoader
from weather_unet_tpu_torch.data.transforms import normalize_batch
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train import metrics
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)
from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

SIZE, BATCH = 32, 2
W_EST = torch.from_numpy(np.random.default_rng(5).standard_normal(
    (3, 5)).astype(np.float32))


def est_apply(images):
    return images.mean(dim=(2, 3)) @ W_EST.to(images.dtype)


class Images:
    """Seeded uint8 images in FlickrDataset's (image, condition, photo id)
    layout, decoded nowhere."""

    def __init__(self, n, seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8)
        self.conds = rng.standard_normal((n, 5)).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.conds[i], str(i)


class Signaling:
    """A loader that sends SIGTERM to this process when it hands out batch
    ``fire_at`` of the epoch it is built for (the platform's preemption
    notice, as in tests/test_preemption.py)."""

    def __init__(self, loader, fire_at):
        self.loader, self.fire_at = loader, fire_at
        self.drop_last = loader.drop_last

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i == self.fire_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


def loaders(data, fire_at=None):
    def train():
        ld = BatchLoader(data, BATCH, shuffle=True, num_workers=2)
        return ld if fire_at is None else Signaling(ld, fire_at)

    def rand():
        return BatchLoader(data, BATCH, shuffle=True, seed=1, num_workers=2)

    return train, rand


def cfg_of(**kw):
    return GanConfig(**{"input_size": SIZE, "batch_size": BATCH,
                        "num_epoch": 2, "dropout_rate": 0.3, **kw})


def trainer(tmp_path, cfg, sub="a", every=1000, **kw):
    tr = WeatherTransferTrainer(cfg, est_apply, save_dir=str(tmp_path / sub),
                                name="g", log_dir=str(tmp_path / "runs"),
                                device="cpu", **kw)
    tr.EVAL_PER_STEP = tr.DISPLAY_PER_STEP = every
    return tr


def state_tensors(state):
    """Every tensor of a GAN state: both networks' state dicts and both Adam
    states, flattened to name -> tensor."""
    out = {}
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        out.update({f"{net}.{k}": v for k, v in
                    ts.module.state_dict().items()})
        for i, st in ts.optimizer.state_dict()["state"].items():
            out.update({f"{net}.opt.{i}.{k}": v for k, v in st.items()})
    return out


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert ((a.epoch, a.global_step, a.gen.step, a.disc.step)
            == (b.epoch, b.global_step, b.gen.step, b.disc.step))


def test_fit_equals_hand_loop(tmp_path):
    """Two epochs of 4 steps, the generator every second step."""
    cfg = cfg_of(gd_train_ratio=2)
    data = Images(9)
    tr = trainer(tmp_path, cfg)
    tr.fit(*loaders(data))

    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    step = make_gan_step(gen, disc, est_apply, cfg)
    g = torch.Generator()
    zeros = torch.zeros(BATCH, dtype=torch.long)
    train, rand = loaders(data)
    gstep = 0
    for epoch in range(2):
        tl, rl = train(), rand()
        tl.set_epoch(epoch)
        rl.set_epoch(epoch)
        for (x, *_), (r, *_) in zip(tl, rl):
            gstep += 1
            g.manual_seed(fold_seed(1, gstep))
            state, _ = step(state, normalize_batch(x, SIZE), zeros,
                            normalize_batch(r, SIZE), zeros, g,
                            do_g=gstep % 2 == 0)
        state.epoch += 1
    assert (state.global_step, state.gen.step) == (8, 4)
    assert_states_equal(tr.state, state)


def test_preempted_run_resumes_bit_equal(tmp_path, capsys):
    cfg = cfg_of()
    data = Images(9)
    whole = trainer(tmp_path, cfg, "whole")
    whole.fit(*loaders(data))

    handler = signal.getsignal(signal.SIGTERM)
    first = trainer(tmp_path, cfg, "cut")
    first.fit(*loaders(data, fire_at=2))     # SIGTERM with batch 2 of epoch 0
    out = capsys.readouterr().out
    assert "preemption: signal 15" in out and "(preempted)" in out
    stop_step = first.state.global_step
    assert stop_step == 2
    assert os.path.basename(ckpt.latest_checkpoint(
        str(tmp_path / "cut"), "g")) == f"ckpt_s{stop_step:010d}.pt"
    assert signal.getsignal(signal.SIGTERM) is handler      # restored

    second = trainer(tmp_path, cfg, "cut")
    out = capsys.readouterr().out
    assert "resumed from" in out and second.state.global_step == stop_step
    second.fit(*loaders(data))
    out = capsys.readouterr().out
    assert "resume: fast-forwarding 2/4 batches of epoch 0" in out
    assert second.state.global_step == 8
    assert_states_equal(second.state, whole.state)


def test_cadence_terminal_save_evaluation_and_export(tmp_path):
    """Saves every 3 steps and at the end (step 8), with the reference
    bundle beside each; evaluation and summaries at their cadences."""
    cfg = cfg_of()
    data = Images(9)
    tr = trainer(tmp_path, cfg, every=3, export_torch=True)
    tr.DISPLAY_PER_STEP = 4
    x = normalize_batch(data.images[:BATCH], SIZE)
    tb = ((x, torch.from_numpy(data.conds[:BATCH])),
          (x, torch.from_numpy(data.conds[2:2 + BATCH])))
    tr.fit(*loaders(data), test_batches=tb)
    names = sorted(os.listdir(tmp_path / "a" / "g"))
    assert names == ["ckpt_s0000000003.pt", "ckpt_s0000000006.pt",
                     "ckpt_s0000000008.pt", "g_e0000_s3.pt", "g_e0001_s6.pt",
                     "g_e0002_s8.pt"]
    assert {f"losses/{k}/test" for k in ("g_loss_adv", "g_loss_l1",
                                         "g_loss_w", "d_loss")} <= set(
        tr.scalar_dict)
    assert tr.scalar_dict["perf/images_per_sec"] > 0
    assert "losses/g_loss/train" in tr.scalar_dict
    bundle = torch.load(tmp_path / "a" / "g" / "g_e0002_s8.pt",
                        weights_only=True)
    assert (bundle["epoch"], bundle["global_step"]) == (2, 8)
    sd = tr.gen.state_dict()
    assert bundle["inference"].keys() == sd.keys()
    assert all(torch.equal(bundle["inference"][k], v) for k, v in sd.items())
    sd = tr.disc.state_dict()
    assert set(sd) < set(bundle["discriminator"])      # + each ".weight"
    assert all(torch.equal(bundle["discriminator"][k], v)
               for k, v in sd.items() if not k.endswith("weight_v"))
    assert glob.glob(str(tmp_path / "runs" / "*"))
    grid_in = np.random.default_rng(1).standard_normal((3, 5, 4, 3))
    for args in ((grid_in, 2), (grid_in[:1], 1)):
        np.testing.assert_array_equal(metrics.make_grid(*args),
                                      jax_metrics.make_grid(*args))
    np.testing.assert_array_equal(
        metrics.image_table(grid_in, [grid_in, 2 * grid_in]),
        jax_metrics.image_table(grid_in, [grid_in, 2 * grid_in]))
    assert metrics.run_comment(1e-4, 2, 3, "g") == jax_metrics.run_comment(
        1e-4, 2, 3, "g")


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    cfg = cfg_of(num_epoch=1)
    tr = trainer(tmp_path, cfg)
    tr.fit(*loaders(Images(5)))               # 2 steps, terminal save
    assert tr.state.global_step == 2
    with ckpt.AsyncCheckpointer() as saver:
        saver.save(str(tmp_path), "rt", 2, ckpt.gan_tree(tr.state, 7))
        path = saver.wait()
        saver.save(str(tmp_path), "rt", 1, {"x": torch.ones(1)})
    assert ckpt.latest_checkpoint(str(tmp_path), "rt") == path
    assert ckpt.latest_checkpoint(str(tmp_path), "none") is None
    assert not glob.glob(str(tmp_path / "rt" / "*.tmp.*"))
    _, _, fresh = build_gan_state(cfg, 3, "cpu")
    tree = ckpt.restore_checkpoint(path, fresh)
    assert tree["seed"] == 7
    assert_states_equal(fresh, tr.state)
    # the trainer resumes from the newest file of its own directory
    assert trainer(tmp_path, cfg).state.global_step == 2


def test_nan_guard_rolls_back(tmp_path, capsys):
    """The estimator's output is NaN for the 4th batch: at step 4 the guard
    restores the step-2 checkpoint and goes on re-seeded; the run ends at
    step 4 with finite metrics and one rollback."""
    poison = {"on": False}

    def est(images):
        out = est_apply(images)
        return out * float("nan") if poison["on"] else out

    class Poisoning(Signaling):
        def __iter__(self):
            for i, batch in enumerate(self.loader):
                poison["on"] = i == 3
                yield batch

    data = Images(12)
    cfg = cfg_of(num_epoch=1)
    tr = WeatherTransferTrainer(cfg, est, save_dir=str(tmp_path), name="g",
                                log_dir=str(tmp_path / "runs"),
                                device="cpu", nan_guard=True)
    tr.EVAL_PER_STEP, tr.DISPLAY_PER_STEP = 2, 1000
    train, rand = loaders(data)
    tr.fit(lambda: Poisoning(train(), None), rand)
    out = capsys.readouterr().out
    assert "nan_guard: non-finite metrics" in out and "retry 1/3" in out
    assert tr._rollbacks == 1 and tr.state.global_step == 4
    assert not tr._nonfinite_metrics()
    assert all(torch.isfinite(p).all() for p in tr.gen.parameters())


def test_export_torch_gan_matches_jax(tmp_path):
    jcfg = jax_gan.GanConfig(input_size=16, batch_size=BATCH)
    _, _, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    jax_ckpt.export_torch_gan(
        str(tmp_path / "jax.pt"), {"params": jstate.gen.params},
        {"params": jstate.disc.params, "spectral": jstate.spectral}, 3, 17)
    gen, disc, state = build_gan_state(
        GanConfig(input_size=16, batch_size=BATCH), 1, "cpu")
    load_jax_state(state, jstate)
    ckpt.export_torch_gan(str(tmp_path / "port.pt"), gen, disc, 3, 17)
    want = torch.load(tmp_path / "jax.pt", weights_only=True)
    got = torch.load(tmp_path / "port.pt", weights_only=True)
    assert got.keys() == want.keys()
    assert (got["epoch"], got["global_step"]) == (3, 17)
    for key in ("inference", "discriminator"):
        assert got[key].keys() == want[key].keys()
        for k, v in want[key].items():
            assert got[key][k].dtype == v.dtype, k
            if k.endswith((".weight", ".weight_v")) and key == "discriminator":
                # derived by a float32 matrix-vector product, which BLAS
                # sums in another order for a transposed layout
                torch.testing.assert_close(got[key][k], v, rtol=1e-6,
                                           atol=1e-7, msg=k)
            else:
                assert torch.equal(got[key][k], v), k


def test_unported_options_and_missing_gpu_raise(tmp_path, monkeypatch):
    """Tensor parallelism without a plan's 'model' axis meets the JAX
    package's guard, and a plan of two devices in one process the
    one-rank-a-process refusal (the split trainer runs one rank a process:
    tests/test_torch_tensor_parallel.py); a plan's data axis trains (the
    test below)."""
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    cfg = cfg_of()
    for kw, match in ((dict(plan=make_mesh(["cpu", "cpu"], model=2)),
                       "parallel.launch -n K"),
                      (dict(tensor_parallel=True),
                       "tensor_parallel requires a mesh with a 'model' "
                       "axis of >= 2 devices")):
        with pytest.raises(ValueError, match=match):
            trainer(tmp_path, cfg, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WeatherTransferTrainer(cfg, est_apply, save_dir=str(tmp_path),
                               log_dir=str(tmp_path / "runs"))


def test_a_plan_of_one_device_trains_as_the_plain_trainer(tmp_path):
    """``plan=make_mesh(["cpu"])``: one rank, data axis 1; fit equals the
    trainer without a plan bit for bit (the data-parallel runs of several
    ranks are in tests/test_torch_data_parallel.py)."""
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    data = Images(8)
    cfg = cfg_of(num_epoch=1)
    runs = []
    for sub, kw in (("plain", {}), ("plan", dict(plan=make_mesh(["cpu"])))):
        tr = trainer(tmp_path, cfg, sub=sub, **kw)
        assert (tr.plan is None) == (not kw)
        tr.fit(*loaders(data))
        runs.append(state_tensors(tr.state))
    assert runs[0].keys() == runs[1].keys()
    for k, v in runs[0].items():
        assert torch.equal(v, runs[1][k]), k
