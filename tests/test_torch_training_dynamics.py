"""Training dynamics of the port over many steps, on the CPU -- the port of
``tests/test_training_dynamics.py`` and of
``tests/test_bf16_training.py::test_bf16_training_tracks_f32``, at their
sizes, step counts and thresholds, unchanged:

* the discriminator learns: 32x32, batch 8, 60 combined steps, the mean of
  the last 10 hinge losses below the mean of the first 10;
* the generator learns weather transfer: the same size, batch and steps on
  smooth synthetic images, the frozen estimator a linear readout of mean
  colour (``examples/synthetic_weather_demo_torch.py``): readback error
  below 0.60 of its start and below 0.45 of the no-transfer baseline,
  reconstruction L1 below 0.5;
* the estimator converges: a depth-(1, 1, 1, 1) ResNet at 32x32, batch 16,
  50 Adam(1e-3) steps on one batch, the last MSE below 0.2 of the first;
* bfloat16 tracks float32: 50 combined steps at 16x16, batch 2, dropout 0:
  finite everywhere, ``g_loss`` and ``loss_con`` within a mean relative
  drift of 0.05, ``d_loss`` within 0.2 over the first 20 steps, every ``u``
  of the bfloat16 run unit-norm within 1e-2 and its power-iteration sigma
  within 10% of the true top singular value.

The port runs alone (its own seeded init; JAX's versions of these tests run
in the suite): the inputs come from the JAX tests' numpy seeds, the
dropout masks from one generator per step.  Plus the demo itself, a few
steps at 16x16.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, no_thread_left, one_torch_thread)
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.models import ResNet
from weather_unet_tpu_torch.ops.spectral import power_iteration, weight_matrix
from weather_unet_tpu_torch.train import supervised as sup
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)

DEMO = pathlib.Path(__file__).resolve().parent.parent / "examples" / (
    "synthetic_weather_demo_torch.py")


def demo_module():
    spec = importlib.util.spec_from_file_location("wut_demo_torch", DEMO)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def linear_readout(w):
    w_t = torch.from_numpy(w)

    def est_apply(images):                       # NCHW
        return images.mean(dim=(2, 3)) @ w_t.to(images.dtype)

    return est_apply


def test_gan_discriminator_learns(rng):
    size, batch = 32, 8
    cfg = GanConfig(input_size=size, batch_size=batch, lr=2e-4)
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    est_apply = linear_readout(rng.standard_normal((3, 5)).astype(np.float32))
    step = make_gan_step(gen, disc, est_apply, cfg)
    zeros = torch.zeros(batch, dtype=torch.long)
    generator = train_generator(0, "cpu")
    d_losses, g_w = [], []
    for i in range(60):
        r = np.random.default_rng(i)
        images = r.standard_normal((batch, size, size, 3)).astype(np.float32)
        rand = r.standard_normal((batch, size, size, 3)).astype(np.float32)
        generator.manual_seed(100 + i)
        state, metrics = step(state, nchw(images), zeros, nchw(rand), zeros,
                              generator, do_g=True)
        d_losses.append(float(metrics["d_loss"]))
        g_w.append(float(metrics["g_loss_w"]))
    assert all(np.isfinite(v) for v in d_losses + g_w)
    # hinge D loss reliably falls from its ~2.0 starting level
    assert np.mean(d_losses[-10:]) < np.mean(d_losses[:10])
    assert state.global_step == 60


def test_gan_generator_learns_weather_transfer(rng):
    size, batch = 32, 8
    est_apply = linear_readout(rng.standard_normal((3, 5)).astype(np.float32))
    synthetic_batch = demo_module().synthetic_batch
    cfg = GanConfig(input_size=size, batch_size=batch, lr=2e-4)
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    step = make_gan_step(gen, disc, est_apply, cfg)

    @torch.no_grad()
    def readback(images, conds):
        fake = gen(images, conds)
        err = float((est_apply(fake) - conds).abs().mean())
        return err, float((fake - images).abs().mean())

    data_rng = np.random.default_rng(0)
    eval_imgs = nchw(synthetic_batch(data_rng, batch, size))
    # target conditions come from OTHER images' signals (transfer, not
    # identity)
    eval_conds = est_apply(nchw(synthetic_batch(data_rng, batch, size)))
    base_err = float((est_apply(eval_imgs) - eval_conds).abs().mean())
    err_init, _ = readback(eval_imgs, eval_conds)

    zeros = torch.zeros(batch, dtype=torch.long)
    generator = train_generator(0, "cpu")
    for i in range(1, 61):
        imgs = nchw(synthetic_batch(data_rng, batch, size))
        rand = nchw(synthetic_batch(data_rng, batch, size))
        generator.manual_seed(1000 + i)
        state, _ = step(state, imgs, zeros, rand, zeros, generator, do_g=True)

    err, recon = readback(eval_imgs, eval_conds)
    assert np.isfinite(err) and np.isfinite(recon)
    assert err < 0.60 * err_init, (
        f"generator did not learn: |est(G(x,c))-c| {err_init:.4f} -> "
        f"{err:.4f}")
    assert err < 0.45 * base_err, (
        f"no transfer vs untouched input: base {base_err:.4f}, got {err:.4f}")
    assert recon < 0.5, f"reconstruction degenerated: L1={recon:.4f}"


def test_estimator_training_converges(rng):
    size, batch = 32, 16
    model = ResNet((1, 1, 1, 1), 5,
                   generator=torch.Generator().manual_seed(0))
    state = sup.build_supervised_state(model, 1e-3, 0.0)   # torch_adam(1e-3)
    step = sup.make_estimator_step()
    w = rng.standard_normal((3, 5)).astype(np.float32)
    # overfit one fixed batch -- deterministic convergence check
    x = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
    sig = torch.from_numpy(x.mean(axis=(1, 2)) @ w)
    xt = nchw(x)
    losses = []
    for _ in range(50):
        state, metrics = step(state, xt, sig)
        losses.append(float(metrics["mse"]))
    assert losses[-1] < 0.2 * losses[0], (
        f"no convergence: {losses[0]} -> {losses[-1]}")


def _bf16_run(dtype, steps=50):
    size, batch = 16, 2
    cfg = GanConfig(input_size=size, batch_size=batch, dropout_rate=0.0,
                    dtype=dtype)
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    est_apply = linear_readout(np.random.default_rng(7).standard_normal(
        (3, 5)).astype(np.float32))
    step = make_gan_step(gen, disc, est_apply, cfg)
    rng = np.random.default_rng(0)
    zeros = torch.zeros(batch, dtype=torch.long)
    traj = []
    for _ in range(steps):
        im = nchw(rng.standard_normal((batch, size, size, 3)).astype(
            np.float32)).to(dtype)
        rim = nchw(rng.standard_normal((batch, size, size, 3)).astype(
            np.float32)).to(dtype)
        state, m = step(state, im, zeros, rim, zeros, None, do_g=True)
        traj.append({k: float(v) for k, v in m.items()})
    return traj, gen, disc


def test_bf16_training_tracks_f32():
    t32, _, _ = _bf16_run(torch.float32)
    t16, gen16, disc16 = _bf16_run(torch.bfloat16)

    # 1. no NaN/Inf anywhere in 50 steps of bf16 training
    for i, m in enumerate(t16):
        assert all(np.isfinite(v) for v in m.values()), (
            f"non-finite at step {i}: {m}")
    assert all(torch.isfinite(t.float()).all()
               for net in (gen16, disc16) for t in net.state_dict().values())

    # 2. loss trajectories within tolerance
    for key, rel_tol in (("g_loss", 0.05), ("loss_con", 0.05)):
        a = np.array([x[key] for x in t32])
        b = np.array([x[key] for x in t16])
        rel = np.abs(a - b) / (np.abs(a) + 1e-2)
        assert rel.mean() < rel_tol, f"{key} mean rel drift {rel.mean():.4f}"
    d32 = np.array([x["d_loss"] for x in t32])
    d16 = np.array([x["d_loss"] for x in t16])
    assert np.abs(d32 - d16)[:20].mean() < 0.2

    # 3. the bf16 run's power-iteration state: unit u, and sigma from it
    # within 10% of the true top singular value of its own weights
    sd = disc16.state_dict()
    checked = 0
    for key in [k for k in sd if k.endswith(".weight_u")]:
        u = sd[key].float()
        assert abs(float(torch.linalg.vector_norm(u)) - 1.0) < 1e-2, key
        w_mat = weight_matrix(sd[key[:-len("_u")] + "_orig"].float())
        sigma_est, _, _ = power_iteration(w_mat, u, update=False)
        sigma_true = float(torch.linalg.svdvals(w_mat)[0])
        assert abs(float(sigma_est) - sigma_true) / sigma_true < 0.10, (
            f"{key}: power-iter sigma {float(sigma_est):.4f} vs svd "
            f"{sigma_true:.4f}")
        checked += 1
    assert checked >= 5, f"only {checked} spectral layers checked"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_demo_runs_and_reports(dtype, tmp_path):
    """The torch demo on the CPU, a few steps at 16x16: the JAX example's
    report lines, one report a window, every step's losses, the tier's run
    equal to the eager one (no CUDA graph on a CPU) and its counters
    returned (one program: every step updates G)."""
    module = demo_module()
    argv = ["--device", "cpu", "--steps", "4", "--size", "16", "--batch", "2",
            "--report_every", "2", "--dtype", dtype]
    lines = []
    eager = module.run(argv, log=lines.append)
    tier = module.run(argv + ["--aot_cache", str(tmp_path / "aot")],
                      log=lambda _: None)
    assert lines[0].startswith("baseline |est(x) - c| (no transfer): ")
    assert lines[1].startswith("untrained G: readback|est(G(x,c))-c|=")
    assert lines[2].startswith("step     2: readback|est(G(x,c))-c|=")
    assert lines[-1].startswith("FINAL: weather-consistency improved ")
    assert [r["step"] for r in eager["reports"]] == [2, 4]
    assert eager["losses"].shape == (4, 2)
    assert np.isfinite(eager["losses"]).all()
    assert np.array_equal(eager["losses"], tier["losses"])
    assert eager["final"] == tier["final"]
    assert eager["aot"] is None and tier["aot"] == {
        "programs": 1, "captures": 0, "capture_s": 0.0}
