"""Resuming a JAX-package training run in the port, on the CPU: the JAX
``GanTrainState`` and supervised checkpoints (flax msgpack, written by
``weather_unet_tpu.train.checkpoint.save_checkpoint``) loaded into the
port's trainers through ``train/checkpoint.py`` and the Adam converters of
``compat/torch_io.py``.

The GAN: JAX trains two steps (16x16, batch 2, dropout 0) and saves; a port
``WeatherTransferTrainer`` whose ``save_dir`` is that run resumes from it
and takes step 3, held to JAX's own step 3 at the bars
``tests/test_torch_gan.py`` holds one step to: losses rtol 2e-4 (atol 1e-5:
``g_loss_adv`` cancels to ~1e-2), parameters within the Adam sign-flip
bound of step 3, Adam's moments within ``MOMENT_TOL`` of the network's
largest element, u 1e-4.  The supervised loop: each of the three layouts
the JAX loop accepts, then one step against JAX's at
``tests/test_torch_supervised.py``'s bars.  The converters: a port state
through the JAX layout and back is bit-exact, and a tree that does not fit
raises naming its first differing key and loads nothing."""

import functools
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_gan import MOMENT_TOL, assert_adam_close, jax_sds
from tests.test_torch_resnet import jax_resnet_variables, port_resnet
from tests.torch_port_util import (  # noqa: F401
    close_summary_writers, nchw, no_thread_left, one_torch_thread)
from weather_unet_tpu.core.optim import torch_adam as jax_adam
from weather_unet_tpu.core.state import TrainState as JaxState
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu.train import supervised as jax_sup
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train import supervised as sup
from weather_unet_tpu_torch.train.gan import GanConfig, build_gan_state
from weather_unet_tpu_torch.train.loops import (
    WeatherTransferTrainer, train_supervised)

SIZE, BATCH, LR = 16, 2, 1e-4
SUP_SIZE, SUP_B, COUNTS, NCLS, WD = 32, 4, (1, 1, 1, 1), 5, 1e-4


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def gan_kw(mode):
    kw = dict(input_size=SIZE, batch_size=BATCH, dropout_rate=0.0, lr=LR,
              num_epoch=1)
    if mode == "cls_ce":
        kw.update(mode="cls", cross_ent=True)
    return kw


EST_W = np.random.default_rng(5).standard_normal((3, 5)).astype(np.float32)


def jest(images):
    return jnp.mean(images, axis=(1, 2)) @ jnp.asarray(EST_W)


def est(images):
    return images.mean(dim=(2, 3)) @ torch.from_numpy(EST_W).to(images.dtype)


def gan_batches(n):
    rng = np.random.default_rng(13)
    return [tuple(rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
        np.float32) for _ in range(2)) for _ in range(n)]


def port_moments_sd(ts):
    """(exp_avg, exp_avg_sq) state dicts (numpy) of a port network."""
    return tuple({n: ts.optimizer.state[p][key].numpy()
                  for n, p in ts.module.named_parameters()
                  if p in ts.optimizer.state}
                 for key in ("exp_avg", "exp_avg_sq"))


@pytest.mark.parametrize("mode", ["est", "cls_ce"])
def test_gan_trainer_resumes_a_jax_run(tmp_path, mode, capsys):
    """JAX steps 1-2 and its checkpoint; the port trainer resumes from the
    run's directory and takes step 3 against JAX's step 3."""
    jcfg = jax_gan.GanConfig(**gan_kw(mode))
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    jstep = jax.jit(functools.partial(
        jax_gan.make_gan_step(jgen, jdisc, jest, jcfg), do_g=True))
    labels = np.array([1, 3], np.int32)
    batches = gan_batches(3)
    for i, (x, r) in enumerate(batches[:2]):
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(r), jnp.asarray(labels),
                          jax.random.key(i))
    saved = jax_ckpt.save_checkpoint(str(tmp_path / "cp"), "run", 2, jstate)

    tr = WeatherTransferTrainer(GanConfig(**gan_kw(mode)), est,
                                save_dir=str(tmp_path / "cp"), name="run",
                                log_dir=str(tmp_path / "runs"),
                                device="cpu")
    assert f"resumed from {saved} at step 2" in capsys.readouterr().out
    state = tr.state
    assert (state.global_step, state.gen.step, state.disc.step,
            state.epoch) == (2, 2, 2, 0)
    # the load itself is exact: the layout maps are transposes
    for got, want in zip((tr.gen.state_dict(), tr.disc.state_dict()),
                         jax_sds(jstate)):
        for k, v in want.items():
            if ".emb." not in k and not k.endswith("weight_v"):
                assert np.array_equal(got[k].numpy(), v), k

    x, r = batches[2]
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(labels),
                       jnp.asarray(r), jnp.asarray(labels), jax.random.key(2))
    state, m = tr._step(state, nchw(x), torch.from_numpy(labels), nchw(r),
                        torch.from_numpy(labels), train_generator(0, "cpu"),
                        do_g=True)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    want_p = jax_sds(jstate)
    want_m = (jax_sds(jstate, lambda ts: ts.opt_state[1].mu),
              jax_sds(jstate, lambda ts: ts.opt_state[1].nu))
    for j, (ts, what) in enumerate(((state.gen, "gen"),
                                    (state.disc, "disc"))):
        sd = {k: v.numpy() for k, v in ts.module.state_dict().items()}
        names = sorted(k for k in sd if ".emb." not in k
                       and not k.endswith(("weight_u", "weight_v")))
        assert_adam_close(np.concatenate([sd[k].ravel() for k in names]),
                          np.concatenate([np.asarray(want_p[j][k]).ravel()
                                          for k in names]), LR, 3, what)
        for got, want, root in zip(port_moments_sd(ts), want_m,
                                   (False, True)):
            a = np.concatenate([got[k].ravel() for k in sorted(got)])
            b = np.concatenate([np.asarray(want[j][k]).ravel()
                                for k in sorted(got)])
            if root:
                a, b = np.sqrt(a), np.sqrt(b)
            assert np.abs(a - b).max() <= MOMENT_TOL[j] * np.abs(b).max(), (
                what, root)
        assert ts.optimizer.state[next(iter(
            ts.optimizer.state))]["step"].item() == 3.0
    for k, v in tr.disc.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), want_p[1][k], atol=1e-4,
                                       err_msg=k)


def test_latest_checkpoint_orders_by_step_and_prefers_pt(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    for f in ("ckpt_s0000000009.pt", "ckpt_s0000000010.msgpack",
              "ckpt_s0000000010.pt.tmp.1.ab", "notes.txt"):
        (run / f).write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path), "run").endswith(
        "ckpt_s0000000010.msgpack")
    (run / "ckpt_s0000000010.pt").write_bytes(b"")
    assert ckpt.latest_checkpoint(str(tmp_path), "run").endswith(
        "ckpt_s0000000010.pt")
    (run / "ckpt_s00000000011.msgpack").write_bytes(b"")   # wider step
    assert ckpt.latest_checkpoint(str(tmp_path), "run").endswith(
        "ckpt_s00000000011.msgpack")
    assert ckpt.latest_checkpoint(str(tmp_path), "none") is None


def trained_port_gan(seed=3):
    """A port GAN state two steps in (the Adam states exist)."""
    from weather_unet_tpu_torch.train.gan import make_gan_step

    cfg = GanConfig(**gan_kw("est"))
    gen, disc, state = build_gan_state(cfg, seed, "cpu")
    step = make_gan_step(gen, disc, est, cfg)
    z = torch.zeros(BATCH, dtype=torch.long)
    for x, r in gan_batches(2):
        state, _ = step(state, nchw(x), z, nchw(r), z,
                        train_generator(seed, "cpu"), do_g=True)
    state.epoch = 1
    return cfg, state


def all_tensors(state):
    out = {}
    for net in ("gen", "disc"):
        ts = getattr(state, net)
        out.update({f"{net}.{k}": v for k, v in
                    ts.module.state_dict().items()})
        for i, st in ts.optimizer.state_dict()["state"].items():
            out.update({f"{net}.opt.{i}.{k}": v for k, v in st.items()})
    return out


def test_gan_round_trip_through_the_jax_layout_is_exact(tmp_path):
    """Port state -> JAX layout (``gan_tree_to_jax``, flax bytes) -> a fresh
    port state: every tensor bit-equal and the counters equal; JAX's own
    ``restore_checkpoint`` reads the file into its ``GanTrainState``.  JAX
    keeps no ``v``: ``weight_v`` comes back as ``normalize(W^T u)`` of the
    stored ``u`` (the port's step stored the ``v`` of the ``u`` before its
    last update); no forward reads it, each overwrites it."""
    cfg, state = trained_port_gan()
    path = str(tmp_path / "run" / "ckpt_s0000000002.msgpack")
    ckpt.save_checkpoint_file(path, ckpt.gan_tree_to_jax(state))
    _, _, fresh = build_gan_state(cfg, 9, "cpu")
    ckpt.restore_checkpoint(path, fresh)
    want, got = all_tensors(state), all_tensors(fresh)
    assert set(got) == set(want)
    for k in want:
        if ".emb." in k:       # absent from JAX: the fresh state's own
            continue
        if k.endswith("weight_v"):
            w = want[k[:-len("_v")] + "_orig"]
            u = want[k[:-len("_v")] + "_u"]
            v = w.reshape(w.shape[0], -1).T.numpy() @ u.numpy()
            np.testing.assert_allclose(got[k].numpy(),
                                       v / np.linalg.norm(v), atol=1e-6)
            continue
        assert torch.equal(got[k], want[k]), k
    assert (fresh.gen.step, fresh.disc.step, fresh.epoch,
            fresh.global_step) == (2, 2, 1, 2)

    _, _, target = jax_gan.build_gan_state(jax_gan.GanConfig(
        **gan_kw("est")), jax.random.key(0))
    back = jax_ckpt.restore_checkpoint(path, target)
    assert int(back.global_step) == 2 and int(back.gen.opt_state[1].count) == 2
    g_sd, _ = jax_sds(back)
    assert np.array_equal(g_sd["conv_last.weight"],
                          state.gen.module.conv_last.weight.detach().numpy())


@pytest.mark.parametrize("change", ["width", "num_classes", "no_opt_state"])
def test_mismatched_tree_raises_naming_its_key(tmp_path, change):
    """A tree that does not fit the state names the first key that differs
    and leaves the state as it was."""
    cfg, state = trained_port_gan()
    tree = ckpt.gan_tree_to_jax(state)
    if change == "width":
        tree["disc"]["params"]["block1"]["conv1"]["kernel"] = np.zeros(
            (3, 3, 3, 32), np.float32)
        where = "/disc/params/block1/conv1/kernel (shape"
    elif change == "num_classes":
        gen6, _, _ = build_gan_state(GanConfig(**gan_kw("est"),
                                               num_classes=6), 0, "cpu")
        tree["gen"]["params"] = torch_io.cunet_state_dict_to_jax(
            gen6.state_dict())["params"]
        where = "/gen/params/adain1/proj/kernel (shape"
    else:
        del tree["gen"]["opt_state"]
        where = "/gen/opt_state (missing from the file)"
    path = str(tmp_path / "bad.msgpack")
    ckpt.save_checkpoint_file(path, tree)
    _, _, fresh = build_gan_state(cfg, 9, "cpu")
    before = all_tensors(fresh)
    with pytest.raises(ValueError, match="does not fit") as info:
        ckpt.restore_checkpoint(path, fresh)
    assert where in str(info.value)
    after = all_tensors(fresh)
    assert set(after) == set(before) and all(
        torch.equal(after[k], before[k]) for k in before)
    assert fresh.global_step == 0 and fresh.gen.step == 0


# ------------------------------------------------------------- supervised

@pytest.fixture(scope="module")
def sup_setup():
    model, variables = jax_resnet_variables(COUNTS, NCLS, SUP_SIZE)
    rng = np.random.default_rng(7)
    x = [rng.uniform(-1, 1, (SUP_B, SUP_SIZE, SUP_SIZE, 3)).astype(
        np.float32) for _ in range(2)]
    t = [rng.integers(0, NCLS, SUP_B) for _ in range(2)]
    return model, variables, x, t


def port_sup(variables):
    return sup.build_supervised_state(
        port_resnet(variables, COUNTS, NCLS), LR, WD)


def jax_sd(params, batch_stats):
    return {k: np.asarray(v) for k, v in torch_io.resnet_state_dict_from_jax(
        {"params": params, "batch_stats": batch_stats}, COUNTS).items()}


def assert_network_moments_close(ps, js, what):
    """Adam's first moment and the square root of its second after a step,
    within 1e-4 of the network's largest element, the bar
    ``tests/test_torch_gan.py`` holds one step's moments to (a gradient's
    float noise is that of its largest terms; a BatchNorm scale of layer3
    carries 1.4e-6 against 1.3e-6 of its own largest element)."""
    adam = js.opt_state[1]
    for key, tree, f in (("exp_avg", adam.mu, np.asarray),
                         ("exp_avg_sq", adam.nu, np.sqrt)):
        want = jax_sd(tree, js.extra)
        names = [n for n, _ in ps.module.named_parameters()]
        a = np.concatenate([f(ps.optimizer.state[p][key].numpy()).ravel()
                            for _, p in ps.module.named_parameters()])
        b = np.concatenate([f(want[n]).ravel() for n in names])
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), (what, key)


LAYOUTS = {"newest": (), "no_epoch_step": ("epoch_step",),
           "params_only": ("epoch_step", "opt_state")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_supervised_resumes_each_jax_layout(tmp_path, sup_setup, layout,
                                            capsys):
    """A JAX classifier one step in, saved in each layout; the port's
    ``restore_supervised`` takes it (params-only: the epoch after the one
    stored, the optimizer as it was) and its next step matches JAX's;
    ``train_supervised`` resumes from the directory (params-only at epoch
    1 of 1: nothing re-trained)."""
    from tests.test_torch_supervised import (
        assert_moments_close, assert_states_close)

    model, variables, x, t = sup_setup
    jstep = jax.jit(jax_sup.make_classifier_step(model))
    js = JaxState.create(variables["params"], jax_adam(LR, weight_decay=WD),
                         extra=variables["batch_stats"])
    js, _ = jstep(js, jnp.asarray(x[0]), jnp.asarray(t[0]))
    tree = {"params": js.params, "batch_stats": js.extra,
            "opt_state": js.opt_state, "epoch": 0, "global_step": 1,
            "epoch_step": 1}
    for k in LAYOUTS[layout]:
        del tree[k]
    path = jax_ckpt.save_checkpoint(str(tmp_path), "run", 1, tree)

    ps = port_sup(variables)
    restored = ckpt.restore_supervised(path, ps)
    assert restored == {"epoch": 1 if layout == "params_only" else 0,
                        "global_step": 1,
                        "epoch_step": 1 if layout == "newest" else 0}
    sd = ps.module.state_dict()
    for k, v in jax_sd(js.params, js.extra).items():
        want = 1 if k.endswith("num_batches_tracked") else v
        assert np.array_equal(sd[k].numpy(), want), k
    if layout == "params_only":
        assert not ps.optimizer.state           # as it was: fresh
    else:
        assert_moments_close(ps, js, layout)
        js, jm = jstep(js, jnp.asarray(x[1]), jnp.asarray(t[1]))
        ps, pm = sup.make_classifier_step()(ps, nchw(x[1]),
                                            torch.as_tensor(t[1]).long())
        for name in jm:
            np.testing.assert_allclose(float(pm[name]), float(jm[name]),
                                       rtol=2e-4, err_msg=name)
        assert_states_close(ps, js, 2, layout)
        assert_network_moments_close(ps, js, layout)

    loader_calls = []

    def train_loader():
        loader_calls.append(1)
        rng = np.random.default_rng(0)
        return [(rng.integers(0, 256, (SUP_B, SUP_SIZE, SUP_SIZE, 3),
                              np.uint8), rng.integers(0, NCLS, SUP_B))
                for _ in range(2)]

    state = train_supervised(
        sup.make_classifier_step(), sup.make_eval_metrics("classifier"),
        train_loader, lambda: [], state=port_sup(variables), num_epoch=1,
        input_size=SUP_SIZE, save_dir=str(tmp_path), name="run",
        eval_per_iter=100, target_dtype=torch.long)
    out = capsys.readouterr().out
    assert f"resumed from {path} at step 1" in out
    # newest: the rest of epoch 0 (1 batch); without epoch_step: all of it
    # (2); params-only: epoch 0 was complete, nothing runs
    assert state.step == 1 + {"newest": 1, "no_epoch_step": 2,
                              "params_only": 0}[layout]
    assert len(loader_calls) == (0 if layout == "params_only" else 1)


def test_supervised_round_trip_through_the_jax_layout_is_exact(tmp_path,
                                                               sup_setup):
    _, variables, x, t = sup_setup
    ps = port_sup(variables)
    step = sup.make_classifier_step()
    for k in range(2):
        ps, _ = step(ps, nchw(x[k]), torch.as_tensor(t[k]).long())
    path = str(tmp_path / "ckpt_s0000000002.msgpack")
    ckpt.save_checkpoint_file(path, ckpt.supervised_tree_to_jax(ps, 1, 2, 0))
    fresh = port_sup(variables)
    assert ckpt.restore_supervised(path, fresh) == {
        "epoch": 1, "global_step": 2, "epoch_step": 0}
    a, b = ps.module.state_dict(), fresh.module.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = (s.optimizer.state_dict()["state"] for s in (ps, fresh))
    assert set(sa) == set(sb) and all(
        torch.equal(sa[i][k], sb[i][k]) for i in sa for k in sa[i])
    assert fresh.step == 2
    bad = ckpt.supervised_tree_to_jax(ps, 1, 2, 0)
    bad["params"]["fc"]["kernel"] = np.zeros((2048, 3), np.float32)
    ckpt.save_checkpoint_file(path, bad)
    with pytest.raises(ValueError, match="/params/fc/kernel"):
        ckpt.restore_supervised(path, port_sup(variables))


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4], ids=["no_wd", "wd"])
def test_adam_state_found_by_its_fields(sup_setup, weight_decay):
    """optax's Adam state sits at "0" without weight decay and at "1"
    with it; the converter finds it either way, and the inverse writes the
    chain ``torch_adam`` builds."""
    model, variables, x, t = sup_setup
    js = JaxState.create(variables["params"],
                         jax_adam(LR, weight_decay=weight_decay),
                         extra=variables["batch_stats"])
    js, _ = jax.jit(jax_sup.make_classifier_step(model))(
        js, jnp.asarray(x[0]), jnp.asarray(t[0]))
    chain = torch_io._as_tree(js.opt_state)
    assert list(chain) == (["0", "1"] if not weight_decay
                           else ["0", "1", "2"])
    adam = torch_io.find_adam_state(js.opt_state)
    assert int(adam["count"]) == 1
    ps = sup.build_supervised_state(port_resnet(variables, COUNTS, NCLS), LR,
                                    weight_decay)
    by_name = torch_io.adam_state_from_jax(
        js.opt_state, ps.module, torch_io.resnet_state_dict_from_jax,
        {"batch_stats": js.extra})
    assert set(by_name) == {n for n, _ in ps.module.named_parameters()}
    ckpt._load_adam(ps.optimizer, ps.module, by_name)
    back = torch_io.adam_state_to_jax(ps.optimizer, ps.module,
                                      torch_io.resnet_state_dict_to_jax)
    assert list(back) == list(chain)
    flat = jax.tree_util.tree_leaves_with_path(torch_io.find_adam_state(
        back)["mu"])
    want = dict(jax.tree_util.tree_leaves_with_path(adam["mu"]))
    assert len(flat) == len(want) and all(
        np.array_equal(np.asarray(v), np.asarray(want[k])) for k, v in flat)
    with pytest.raises(ValueError, match="one Adam state"):
        torch_io.find_adam_state({"0": {}, "1": {}})
