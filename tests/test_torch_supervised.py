"""The port's supervised pretraining (``train/supervised.py``,
``train/loops.py::train_supervised``) against the JAX package's, on the
CPU, with a depth-(1, 1, 1, 1) ResNet at 32x32, batch 4.

The JAX step functions are jitted on one device (never the JAX
``train_supervised``, which builds the 8-device CPU mesh); weights cross
over through the port's ResNet converters, BatchNorm scale, shift and
running statistics drawn at random.  Bars: losses rtol 2e-4; parameters
within the Adam sign-flip bound (``assert_adam_close``: with Adam's first
update about lr * sign(g), fewer than 0.5% of the elements beyond 5e-5 and
none beyond 1.1 * 2 * lr * sqrt(k) at the k-th update); BatchNorm running
statistics 1e-5; the weighted eval metrics 1e-5.  The loop itself is held
to a hand loop and to itself: a preempted and resumed run equals an
uninterrupted one bit for bit.
"""

import os
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_gan import assert_adam_close
from tests.test_torch_resnet import jax_resnet_variables, port_resnet
from tests.torch_port_util import (  # noqa: F401
    nchw, no_thread_left, one_torch_thread)
from weather_unet_tpu.core.optim import torch_adam as jax_adam
from weather_unet_tpu.core.state import TrainState as JaxState
from weather_unet_tpu.train import supervised as jax_sup
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.core.rng import fold_seed
from weather_unet_tpu_torch.data.transforms import (
    AugmentConfig, augment_batch, normalize_batch)
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train import supervised as sup
from weather_unet_tpu_torch.train.loops import (
    _padded_eval_batches, train_supervised)

COUNTS, NCLS, SIZE, B, LR = (1, 1, 1, 1), 5, 32, 4, 1e-4
MOMENT_TOL = 1e-4
WD = {"classifier": 1e-4, "estimator": 1e-5}


@pytest.fixture(scope="module")
def setup():
    model, variables = jax_resnet_variables(COUNTS, NCLS, SIZE)
    rng = np.random.default_rng(7)
    x = [rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
         for _ in range(3)]
    t = {"classifier": [rng.integers(0, NCLS, B) for _ in range(3)],
         "estimator": [rng.standard_normal((B, NCLS)).astype(np.float32)
                       for _ in range(3)]}
    return model, variables, x, t


def port_state(variables, kind, pre_trained=False):
    return sup.build_supervised_state(
        port_resnet(variables, COUNTS, NCLS), LR, WD[kind], pre_trained)


def jax_step(model, kind, mask=None):
    make = (jax_sup.make_classifier_step if kind == "classifier"
            else jax_sup.make_estimator_step)
    return jax.jit(make(model, mask))


def jax_state(variables, kind):
    return JaxState.create(variables["params"],
                           jax_adam(LR, weight_decay=WD[kind]),
                           extra=variables["batch_stats"])


def port_target(t, kind):
    return torch.as_tensor(t).long() if kind == "classifier" else \
        torch.from_numpy(t)


def as_sd(state):
    sd = torch_io.resnet_state_dict_from_jax(
        {"params": state.params, "batch_stats": state.extra}, COUNTS)
    return {k: np.asarray(v) for k, v in sd.items()}


def assert_states_close(port, jstate, step, what):
    """BatchNorm statistics at 1e-5; the parameters, over the whole network,
    within the sign-flip bound (a small tensor can hold a few elements whose
    gradient is float noise: 4 of bn1's 64 biases in the estimator)."""
    want = as_sd(jstate)
    got = port.module.state_dict()
    params = dict(port.module.named_parameters())
    for k, v in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-5,
                                       err_msg=f"{what} {k}")
    assert_adam_close(
        np.concatenate([params[k].detach().numpy().ravel() for k in params]),
        np.concatenate([want[k].ravel() for k in params]), LR, step, what)


def assert_moments_close(port, jstate, what):
    """Adam's first moment and the square root of its second, each within
    MOMENT_TOL of its largest element (the moments see a gradient's size,
    where the updates see only its sign)."""
    adam = jstate.opt_state[1]
    for key, tree, f in (("exp_avg", adam.mu, np.asarray),
                         ("exp_avg_sq", adam.nu, np.sqrt)):
        moments = as_sd(jstate.replace(params=tree))
        for name, p in port.module.named_parameters():
            got, want = f(port.optimizer.state[p][key].numpy()), f(
                moments[name])
            tol = MOMENT_TOL * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"{what} {key} {name}")


@pytest.mark.parametrize("kind", ["classifier", "estimator"])
def test_steps_and_eval_match_jax(setup, kind):
    """Two steps from the same weights and batches, then the weighted eval
    metrics (a 0-weight row counts nothing)."""
    model, variables, x, t = setup
    jstep = jax_step(model, kind)
    js = jax_state(variables, kind)
    ps = port_state(variables, kind)
    step = (sup.make_classifier_step() if kind == "classifier"
            else sup.make_estimator_step())
    for k in range(2):
        if k:
            # Adam's sign flips compound over unsynchronized steps: resync
            # the parameters and statistics (each side keeps its moments)
            ps.module.load_state_dict({n: torch.tensor(v) for n, v in
                                       as_sd(js).items()})
        js, jm = jstep(js, jnp.asarray(x[k]), jnp.asarray(t[kind][k]))
        ps, pm = step(ps, nchw(x[k]), port_target(t[kind][k], kind))
        assert jm.keys() == pm.keys()
        for name in jm:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=2e-4, err_msg=name)
        assert_states_close(ps, js, k + 1, f"step {k + 1}")
        assert_moments_close(ps, js, f"step {k + 1}")
    assert ps.step == 2
    w = np.asarray([1, 1, 0, 1], np.float32)
    jev = jax.jit(jax_sup.make_eval_metrics(model, kind))(
        js.params, js.extra, jnp.asarray(x[2]), jnp.asarray(t[kind][2]),
        jnp.asarray(w))
    # the port evaluates its own state (within the bounds above of JAX's)
    # and JAX's weights carried across, on which it must agree at 1e-5
    ported = port_state({"params": js.params, "batch_stats": js.extra}, kind)
    pev = sup.make_eval_metrics(kind)(ported.module, nchw(x[2]),
                                      port_target(t[kind][2], kind),
                                      torch.from_numpy(w))
    assert jev.keys() == pev.keys()
    for name in jev:
        np.testing.assert_allclose(float(pev[name]), float(jev[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert ported.module.training      # eval restores the mode


def test_pre_trained_freezes_the_backbone(setup):
    """Three Adam steps with the frozen set: the JAX package's masked
    "frozen" leaves move (its coupled weight decay comes after the mask:
    about lr * sign(p) a step), the port's stay bit-identical, and the
    trainable leaves (layer4, fc) move and agree within the multi-step
    sign-flip bound."""
    model, variables, x, t = setup
    kind = "estimator"
    mask = jax_sup.resnet_pretrained_mask(variables["params"])
    jstep = jax_step(model, kind, mask)
    js = jax_state(variables, kind)
    ps = port_state(variables, kind, pre_trained=True)
    frozen = sup.resnet_pretrained_frozen(ps.module)
    assert {n.split(".")[0] for n in frozen} == {
        "conv1", "bn1", "layer1", "layer2", "layer3"}
    n_params = len(list(ps.module.parameters()))
    assert len(ps.optimizer.param_groups[0]["params"]) == n_params - len(
        frozen)
    before = {k: v.clone() for k, v in ps.module.state_dict().items()}
    step = sup.make_estimator_step()
    for k in range(3):
        js, _ = jstep(js, jnp.asarray(x[k]), jnp.asarray(t[kind][k]))
        ps, _ = step(ps, nchw(x[k]), port_target(t[kind][k], kind))
    after = ps.module.state_dict()
    start, want = as_sd(jax_state(variables, kind)), as_sd(js)
    for name in frozen:
        assert torch.equal(after[name], before[name]), name
        moved = np.abs(want[name] - start[name])
        assert moved.max() > LR, name                # the JAX deviation
        assert moved.max() <= 3 * 1.1 * 2 * LR, name
    # three steps without a resync, and JAX's backbone moved under them:
    # the multi-step bar of ROADMAP.md section 3, no element beyond the
    # largest split after k updates, 1.1 * 2 * lr * sqrt(k); and every
    # trainable leaf moved (the bar alone would pass a leaf left unchanged)
    for n, _ in ps.module.named_parameters():
        if n not in frozen:
            diff = np.abs(after[n].numpy() - want[n]).max()
            assert diff <= 1.1 * 2 * LR * np.sqrt(3), (n, diff)
            moved = (after[n] - before[n]).abs().max().item()
            assert moved > LR / 2, (n, moved)


class Batches:
    """``n`` seeded uint8 batches of (images, labels); ``fire_at`` sends
    SIGTERM to this process when that batch of epoch 1 is handed out."""

    def __init__(self, n=3, b=B, seed=0, fire_at=None):
        rng = np.random.default_rng(seed)
        self.data = [(rng.integers(0, 256, (b, SIZE, SIZE, 3), np.uint8),
                      rng.integers(0, NCLS, b)) for _ in range(n)]
        self.fire_at, self.epoch = fire_at, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i, batch in enumerate(self.data):
            if self.epoch == 1 and i == self.fire_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


class Recording:
    def __init__(self):
        self.records = []

    def add_scalars(self, scalars, step):
        self.records.append((step, dict(scalars)))


def run(variables, tmp_path, name, num_epoch=2, fire_at=None, test=None,
        writer=None, **kw):
    state = port_state(variables, "classifier")
    train_supervised(
        sup.make_classifier_step(), sup.make_eval_metrics("classifier"),
        lambda: Batches(fire_at=fire_at),
        test or (lambda: Batches(1, b=3, seed=9)), state=state,
        num_epoch=num_epoch, writer=writer, input_size=SIZE,
        save_dir=str(tmp_path), name=name, eval_per_iter=2,
        save_per_epoch=5, target_dtype=torch.long, **kw)
    return state


def state_equal(a, b):
    sa, sb = a.module.state_dict(), b.module.state_dict()
    oa, ob = (s.optimizer.state_dict()["state"] for s in (a, b))
    return (a.step == b.step and sa.keys() == sb.keys()
            and all(torch.equal(v, sb[k]) for k, v in sa.items())
            and all(torch.equal(v, ob[i][k]) for i in oa
                    for k, v in oa[i].items()))


def test_loop_equals_hand_loop_with_eval_tail(setup, tmp_path):
    """Two epochs of 3 steps with the device warp: the hand loop (each step
    warped on a generator seeded from (seed, global step)) gives the same
    state bit for bit; the evaluation at steps 0, 2 and 4 averages the
    test split's partial batch of 3 over its real rows, equal to the plain
    eval of those rows; the terminal save holds the final state."""
    _, variables, _, _ = setup
    rec = Recording()
    cfg = AugmentConfig(out_size=SIZE, resized_crop=True, brightness=0.5)
    got = run(variables, tmp_path, "hand", writer=rec, augment_cfg=cfg,
              seed=5)
    want = port_state(variables, "classifier")
    step = sup.make_classifier_step()
    x3, t3 = Batches(1, b=3, seed=9).data[0]
    g, gstep = torch.Generator(), 0
    for _ in range(2):
        for x, t in Batches():
            g.manual_seed(fold_seed(5, gstep))
            want, _ = step(want, augment_batch(g, x, cfg),
                           torch.as_tensor(t).long())
            if gstep == 4:      # the last evaluation follows this step
                ev = sup.make_eval_metrics("classifier")(
                    want.module, normalize_batch(x3),
                    torch.as_tensor(t3).long())
            gstep += 1
    assert state_equal(got, want)
    assert [s for s, _ in rec.records] == [0, 2, 4]
    last = rec.records[-1][1]
    assert np.isclose(last["accuracy/test"], float(ev["accuracy"]),
                      atol=1e-6)
    assert np.isclose(last["loss/test"], float(ev["loss"]), atol=1e-5)
    assert "loss/train" in last
    tree = torch.load(ckpt.latest_checkpoint(str(tmp_path), "hand"),
                      weights_only=True)
    assert (tree["global_step"], tree["epoch"], tree["step"]) == (6, 2, 6)
    assert all(torch.equal(v, tree["model"][k])
               for k, v in want.module.state_dict().items())
    # the padded tail: a full batch passes, a partial one pads to its size
    # with weight 0 rows
    full = (np.zeros((4, 2, 2, 3), np.uint8), np.zeros(4, np.int64))
    tail = (np.ones((3, 2, 2, 3), np.uint8), np.arange(3))
    counts = []
    out = list(_padded_eval_batches([full, tail], counts))
    assert counts == [4, 3] and out[1][0].shape[0] == 4
    assert out[1][2].tolist() == [1, 1, 1, 0] and out[1][1][3] == 2


def test_preempted_run_resumes_bit_equal(setup, tmp_path, capsys):
    """SIGTERM at batch 1 of epoch 1: a checkpoint at step 4 (epoch 1,
    batch 1), a clean stop; the relaunch resumes, fast-forwards one batch,
    ends at step 6 bit-equal to the run that was not interrupted; a third
    launch finds nothing left to run."""
    _, variables, _, _ = setup
    whole = run(variables, tmp_path / "whole", "w")
    cut = run(variables, tmp_path, "p", fire_at=1)
    out = capsys.readouterr().out
    assert "preemption: signal 15" in out and cut.step == 4
    tree = torch.load(ckpt.checkpoint_path(str(tmp_path), "p", 4),
                      weights_only=True)
    assert (tree["epoch"], tree["epoch_step"]) == (1, 1)
    resumed = run(variables, tmp_path, "p")
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 4" in out
    assert "resume: fast-forwarding 1 batches of epoch 1" in out
    assert state_equal(resumed, whole)
    again = run(variables, tmp_path, "p")
    assert "resumed from" in capsys.readouterr().out
    assert state_equal(again, whole)
    with pytest.raises(NotImplementedError, match="Mesh, AOT"):
        run(variables, tmp_path, "x", aot_cache=str(tmp_path))


def test_bf16_step_trains_float32_master_weights(setup):
    """A bfloat16 step: finite metrics, float32 parameters that move, BN
    statistics in float32; the losses near the float32 step's."""
    _, variables, x, t = setup
    losses = {}
    for dt in (torch.float32, torch.bfloat16):
        model = port_resnet(variables, COUNTS, NCLS)
        model.dtype = dt
        state = sup.build_supervised_state(model, LR, WD["estimator"])
        before = model.fc.weight.clone()
        state, m = sup.make_estimator_step()(state, nchw(x[0]),
                                             torch.from_numpy(
                                                 t["estimator"][0]))
        assert all(np.isfinite(float(v)) for v in m.values())
        assert model.fc.weight.dtype == torch.float32
        assert model.bn1.running_mean.dtype == torch.float32
        assert not torch.equal(model.fc.weight, before)
        losses[dt] = float(m["loss"])
    assert abs(losses[torch.bfloat16] - losses[torch.float32]) <= 0.05 * abs(
        losses[torch.float32])
