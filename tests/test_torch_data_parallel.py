"""Data parallelism of the port on the CPU: two gloo ranks in child
processes (``parallel/launch.py``, ``tools/dp_train_torch.py``) train the
GAN trainer (est and cls modes) and ``train_supervised`` on seeded
synthetic data, and each step is held to the function JAX's SPMD step
computes, the single-device step on the global batch:

* the ranks' states are byte-equal to each other and to the checkpoint they
  both wrote;
* each step k, taken from the state the ranks took it from (rank 0's state
  after step k - 1: Adam's sign flips compound over steps taken apart), is
  held to JAX's step and to the port's one-process step on the global batch
  (B=4): losses rtol 2e-4 + atol 1e-5, parameters fewer than 0.5% beyond
  5e-5 and none beyond 2.2·lr·√k, Adam's moments 5e-3 of the network's
  largest element, u 1e-4; ResNet BatchNorm statistics 1e-5;
* world size 1 through the launcher equals the plain trainer bit for bit;
* the ranks' loader rows, joined, are the one-process batch in order, and
  at dropout 0.3 the ranks draw different masks;
* ``WeatherTransfer`` with a replica on each of two CPU devices equals the
  plain one (MAE <= 1e-6) and the JAX package's (< 1e-5), and
  ``serve --data_parallel`` answers;
* ``aot_cache`` under a process group prints the JAX package's warning and
  runs eagerly.

Shapes 16² (GAN) and 32² (ResNet depth (1, 1, 1, 1)), f32, dropout 0, one
torch thread a process; every multi-rank run is bounded by 120 s."""

import argparse
import functools
import importlib.util
import json
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_gan import assert_adam_close, jax_sds, load_jax_state
from tests.test_torch_resnet import jax_resnet_variables, port_resnet
from tests.torch_port_util import (  # noqa: F401
    DP_WORKER, launch_ranks, no_thread_left, one_torch_thread, rank_env,
    rank_log)
from weather_unet_tpu.data.transforms import normalize_batch as jax_norm
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.data.transforms import normalize_batch
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train import supervised as sup
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)

SIZE, B, LR, STEPS = 16, 4, 1e-4, 2
SUP_SIZE, COUNTS, NCLS = 32, (1, 1, 1, 1), 5
MOMENT_TOL = 5e-3
AOT_WARNING = "WARNING: --aot_cache is single-process only"


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def worker():
    """``tools/dp_train_torch.py`` as a module (its data and estimator)."""
    spec = importlib.util.spec_from_file_location("dp_train_torch",
                                                  DP_WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = worker()


def run_worker(tmp_path, out, extra, n=2):
    """``n`` ranks of the worker on the CPU; their JSON records."""
    rc = launch_ranks(n, [sys.executable, DP_WORKER, "--out", str(out)]
                      + extra, tmp_path / f"logs_{out.name}", timeout=120)
    assert rc == 0
    recs = []
    for r in range(n):
        with open(out / f"rank{r}.json") as f:
            recs.append(json.load(f))
    return recs


def rank_bytes(out, r):
    with open(out / f"rank{r}.pt", "rb") as f:
        return f.read()


def jest(images):
    return jnp.mean(images, axis=(1, 2)) @ jnp.asarray(W.est_weights())


def gan_kw(mode):
    kw = dict(input_size=SIZE, batch_size=B, dropout_rate=0.0, lr=LR,
              num_epoch=1)
    if mode == "cls":
        kw.update(mode="cls", cross_ent=True)
    return kw


def global_batches(loaders):
    """The global batches a one-process run of the worker's loaders yields
    at epoch 0 (what the ranks' rows join into)."""
    its = []
    for make in loaders:
        ld = make()
        ld.set_epoch(0)
        its.append([b[0] for b in ld])
    return list(zip(*its))


def port_gan_state(mode, path=None):
    cfg = GanConfig(**gan_kw(mode))
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    if path is not None:
        ckpt.restore_checkpoint(str(path), state)
    return cfg, gen, disc, state


def port_moments(ts):
    return tuple({n: ts.optimizer.state[p][key].numpy()
                  for n, p in ts.module.named_parameters()
                  if p in ts.optimizer.state}
                 for key in ("exp_avg", "exp_avg_sq"))


def assert_gan_step_close(got_m, got_state, want_m, want_p, want_mom,
                          want_u, k, what):
    """One step's losses, parameters, moments and u at the module's bars;
    ``want_*`` as port state dicts (numpy)."""
    assert set(got_m) == set(want_m), what
    for name in want_m:
        np.testing.assert_allclose(got_m[name], float(want_m[name]),
                                   rtol=2e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")
    for j, ts in enumerate((got_state.gen, got_state.disc)):
        sd = {n: v.numpy() for n, v in ts.module.state_dict().items()}
        names = sorted(n for n in sd if ".emb." not in n
                       and not n.endswith(("weight_u", "weight_v")))
        assert_adam_close(np.concatenate([sd[n].ravel() for n in names]),
                          np.concatenate([np.asarray(want_p[j][n]).ravel()
                                          for n in names]),
                          LR, k, f"{what} net {j}")
        for got, want, root in zip(port_moments(ts), want_mom[j],
                                   (False, True)):
            a = np.concatenate([got[n].ravel() for n in sorted(got)])
            b = np.concatenate([np.asarray(want[n]).ravel()
                                for n in sorted(got)])
            if root:
                a, b = np.sqrt(a), np.sqrt(b)
            assert np.abs(a - b).max() <= MOMENT_TOL * np.abs(b).max(), (
                what, j, root)
    for n, v in got_state.disc.module.state_dict().items():
        if n.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), want_u[n], atol=1e-4,
                                       err_msg=f"{what} {n}")


def jax_gan_from_port(state, jtarget, tmp_path):
    """The JAX ``GanTrainState`` holding a port state (through the JAX
    layout the port writes)."""
    path = str(tmp_path / "x" / "ckpt_s0000000000.msgpack")
    ckpt.save_checkpoint_file(path, ckpt.gan_tree_to_jax(state))
    return jax_ckpt.restore_checkpoint(path, jtarget)


@pytest.mark.parametrize("mode", ["est", "cls"])
def test_two_ranks_gan_trainer_is_the_global_batch_step(tmp_path, mode):
    """Two ranks of the GAN trainer, 2 steps at global B=4 from JAX's
    initial state: the ranks byte-equal; each step against JAX's
    ``make_gan_step`` and the port's one-process step at B=4 from the
    ranks' state before it; the AOT tier ignored with JAX's warning."""
    jcfg = jax_gan.GanConfig(**gan_kw(mode))
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    cfg, gen, disc, state = port_gan_state(mode)
    load_jax_state(state, jstate)
    cp = tmp_path / "cp"
    ckpt._write(ckpt.checkpoint_path(str(cp), "run", 0),
                ckpt._to_host(ckpt.gan_tree(state, 0)))
    out = tmp_path / "ranks"
    recs = run_worker(tmp_path, out, [
        "--mode", "gan", "--gan_mode", mode, "--save_dir", str(cp),
        "--size", str(SIZE), "--batch", str(B), "--steps", str(STEPS),
        "--snapshots", "--aot_cache", str(tmp_path / "aot")])
    assert [r["world"] for r in recs] == [2, 2]
    assert recs[0]["metrics"] == recs[1]["metrics"]
    final = rank_bytes(out, 0)
    assert final == rank_bytes(out, 1)
    with open(ckpt.checkpoint_path(str(cp), "run", STEPS), "rb") as f:
        assert f.read() == final            # both ranks wrote these bytes
    for r in (0, 1):
        log = rank_log(tmp_path / "logs_ranks", r)
        assert AOT_WARNING in log and "resumed from" in log

    jstep = jax.jit(functools.partial(
        jax_gan.make_gan_step(jgen, jdisc, jest, jcfg), do_g=True))
    pstep = make_gan_step(gen, disc, W.linear_estimator, cfg)
    zeros = torch.zeros(B, dtype=torch.long)
    args = argparse.Namespace(steps=STEPS, batch=B, size=SIZE)
    for k, (x, r) in enumerate(global_batches(W.gan_loaders(args)), 1):
        before = None if k == 1 else out / f"rank0_s{k - 1}.pt"
        _, _, _, got = port_gan_state(mode, out / f"rank0_s{k}.pt")
        got_m = recs[0]["metrics"][k - 1]
        # JAX's step from the same state
        js = jstate if before is None else jax_gan_from_port(
            port_gan_state(mode, before)[3], jstate, tmp_path)
        lab = jnp.zeros(B, jnp.int32)
        js2, jm = jstep(js, jax_norm(jnp.asarray(x)), lab,
                        jax_norm(jnp.asarray(r)), lab, jax.random.key(k))
        assert_gan_step_close(
            got_m, got, jm, jax_sds(js2),
            tuple(zip(jax_sds(js2, lambda ts: ts.opt_state[1].mu),
                      jax_sds(js2, lambda ts: ts.opt_state[1].nu))),
            jax_sds(js2)[1], k, f"{mode} step {k} vs JAX")
        # the port's one-process step from the same state
        if before is not None:
            ckpt.restore_checkpoint(str(before), state)
        state, pm = pstep(state, normalize_batch(x, SIZE), zeros,
                          normalize_batch(r, SIZE), zeros,
                          train_generator(0, "cpu"), do_g=True)
        want_p = tuple({n: v.numpy() for n, v in ts.module.state_dict()
                        .items()} for ts in (state.gen, state.disc))
        assert_gan_step_close(
            got_m, got, pm, want_p,
            (port_moments(state.gen), port_moments(state.disc)),
            want_p[1], k, f"{mode} step {k} vs one process")


def test_two_ranks_train_supervised_is_the_global_batch_step(tmp_path):
    """Two ranks of ``train_supervised`` (the estimator step, ResNet depth
    (1, 1, 1, 1), 32², global B=4) from JAX's initial variables: the ranks
    byte-equal; each step against JAX's estimator step and the port's
    one-process step at B=4 from the ranks' state before it, BatchNorm's
    statistics (the global batch's, reduced over the ranks) at 1e-5.
    Adam's moments are not held here: on this batch one element of
    ``layer2.0.bn1``'s output sits on the ReLU's kink, so a 4e-6 forward
    difference moves one gradient element by a whole conv gradient, which
    the channel's BatchNorm spreads to its inputs (found by comparing each
    BatchNorm's input gradient, rank against one process)."""
    from tests.test_torch_supervised import (
        assert_states_close, jax_state, jax_step)

    model, variables = jax_resnet_variables(COUNTS, NCLS, SUP_SIZE)
    js = jax_state(variables, "estimator")
    ps = sup.build_supervised_state(port_resnet(variables, COUNTS, NCLS),
                                    LR, 1e-5)
    cp = tmp_path / "cp"
    ckpt._write(ckpt.checkpoint_path(str(cp), "run", 0),
                ckpt._to_host(ckpt.supervised_tree(ps, 0, 0)))
    out = tmp_path / "ranks"
    recs = run_worker(tmp_path, out, [
        "--mode", "sup", "--save_dir", str(cp), "--size", str(SUP_SIZE),
        "--batch", str(B), "--steps", str(STEPS), "--snapshots"])
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert rank_bytes(out, 0) == rank_bytes(out, 1)

    jstep = jax_step(model, "estimator")
    pstep = sup.make_estimator_step()
    args = argparse.Namespace(steps=STEPS, batch=B, size=SUP_SIZE)
    train = W.sup_loaders(args)[0]()
    train.set_epoch(0)
    for k, (x, t) in enumerate(train, 1):
        got = sup.build_supervised_state(
            port_resnet(variables, COUNTS, NCLS), LR, 1e-5)
        ckpt.restore_supervised(str(out / f"rank0_s{k}.pt"), got)
        if k > 1:
            before = str(out / f"rank0_s{k - 1}.pt")
            ckpt.restore_supervised(before, ps)
            path = str(tmp_path / "x" / "ckpt_s0000000000.msgpack")
            ckpt.save_checkpoint_file(
                path, ckpt.supervised_tree_to_jax(ps, 0, 0, 0))
            back = jax_ckpt.restore_checkpoint(path, {
                "params": js.params, "batch_stats": js.extra,
                "opt_state": js.opt_state, "epoch": 0, "global_step": 0,
                "epoch_step": 0})
            js = js.replace(params=back["params"],
                            extra=back["batch_stats"],
                            opt_state=back["opt_state"])
        js, jm = jstep(js, jax_norm(jnp.asarray(x)), jnp.asarray(t))
        ps, pm = pstep(ps, normalize_batch(x, SUP_SIZE), torch.from_numpy(t))
        for want, what in ((jm, "JAX"), (pm, "one process")):
            assert set(want) == set(recs[0]["metrics"][k - 1])
            for name, v in recs[0]["metrics"][k - 1].items():
                np.testing.assert_allclose(v, float(want[name]), rtol=2e-4,
                                           atol=1e-5,
                                           err_msg=f"step {k} {what} {name}")
        assert_states_close(got, js, k, f"step {k} vs JAX")
        one = {n: v.numpy() for n, v in ps.module.state_dict().items()}
        for n, v in got.module.state_dict().items():
            if n.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), one[n], atol=1e-5,
                                           err_msg=n)
        params = dict(got.module.named_parameters())
        assert_adam_close(
            np.concatenate([p.detach().numpy().ravel()
                            for p in params.values()]),
            np.concatenate([one[n].ravel() for n in params]), LR, k,
            f"step {k} vs one process")


def test_world_of_one_through_the_launcher_is_the_plain_trainer(tmp_path):
    """``launch -n 1 --cpu`` (a gloo group of one: the broadcast and the
    all-reduces run) against the worker run plainly: the same metrics and
    the same checkpoint bytes, for the GAN trainer and train_supervised."""
    for mode, size in (("gan", SIZE), ("sup", SUP_SIZE)):
        extra = ["--mode", mode, "--size", str(size), "--batch", str(B),
                 "--steps", str(STEPS), "--dropout", "0.3"]
        one = tmp_path / f"one_{mode}"
        recs = run_worker(tmp_path, one, extra + [
            "--save_dir", str(tmp_path / f"cp1_{mode}")], n=1)
        assert recs[0]["world"] == 1
        assert "joined the process group as rank 0/1 (gloo, cpu)" in (
            rank_log(tmp_path / f"logs_{one.name}", 0))
        plain = tmp_path / f"plain_{mode}"
        res = subprocess.run(
            [sys.executable, DP_WORKER, "--out", str(plain), "--device",
             "cpu", "--save_dir", str(tmp_path / f"cp0_{mode}")] + extra,
            env=rank_env(), capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        with open(plain / "rank0.json") as f:
            want = json.load(f)
        assert want["world"] == 1 and "joined" not in res.stdout
        assert recs[0]["metrics"] == want["metrics"], mode
        assert rank_bytes(one, 0) == rank_bytes(plain, 0), mode


ROWS_SCRIPT = r"""
import json, os, sys
sys.modules["torch.utils.tensorboard"] = None
import numpy as np
import torch
from weather_unet_tpu_torch.core.rng import fold_seed
from weather_unet_tpu_torch.data.pipeline import (
    BatchLoader, assemble_global_batch, device_prefetch)
from weather_unet_tpu_torch.parallel import launch
from weather_unet_tpu_torch.train.gan import GanConfig
from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

launch.maybe_initialize()
rank = launch.process_index()
ds = [(np.full((2,), i, np.int64), i) for i in range(10)]
ld = BatchLoader(ds, 4, shuffle=True, seed=3, num_workers=2,
                 process_shard=True)
ld.set_epoch(1)
rows = [b[1].tolist() for b in ld]
glob = [b[0].tolist() for b in device_prefetch(
    iter([(np.arange(4),)]), "cpu", assembly="global")]
local = assemble_global_batch("cpu", np.arange(2)).tolist()
try:
    BatchLoader(ds, 4, drop_last=False, process_shard=True)
    tail = "accepted"
except ValueError as e:
    tail = str(e)
tr = WeatherTransferTrainer(
    GanConfig(input_size=16, batch_size=4, dropout_rate=0.3),
    lambda x: x.mean(dim=(2, 3)).repeat(1, 2)[:, :5],
    save_dir=sys.argv[1], log_dir=os.path.join(sys.argv[1], "runs"),
    device="cpu")
tr._step_rng.manual_seed(fold_seed(tr._base_seed, 1))
x = torch.zeros(1, 3, 16, 16)
with torch.no_grad():
    y = tr.gen(x, torch.eye(5)[:1], train=True, generator=tr._step_rng)
with open(os.path.join(sys.argv[1], f"r{rank}.json"), "w") as f:
    json.dump({"rows": rows, "global": glob, "local": local, "tail": tail,
               "y": y.flatten().tolist(), "writer": tr.writer is not None},
              f)
"""


def test_loader_rows_join_into_the_global_batch_and_masks_differ(
        tmp_path):
    """Two ranks: ``BatchLoader(process_shard=True)`` gives each its
    ``process_slice`` of every batch of one seeded order, so the rows
    joined are the one-process batches in order; ``assembly="global"``
    cuts a global batch to the rank's rows, ``assemble_global_batch``
    keeps them; a tail that does not divide over the ranks is refused at
    construction; the GAN trainer's dropout generators fold in the rank
    (the same input, rate 0.3, gives different outputs), and rank 0 alone
    opens a summary writer."""
    from weather_unet_tpu_torch.data.pipeline import BatchLoader

    rc = launch_ranks(2, [sys.executable, "-c", ROWS_SCRIPT, str(tmp_path)],
                      tmp_path / "logs", timeout=120)
    assert rc == 0
    outs = []
    for r in (0, 1):
        with open(tmp_path / f"r{r}.json") as f:
            outs.append(json.load(f))
    ds = [(np.full((2,), i, np.int64), i) for i in range(10)]
    ld = BatchLoader(ds, 4, shuffle=True, seed=3, num_workers=2)
    ld.set_epoch(1)
    want = [b[1].tolist() for b in ld]
    assert len(want) == 2
    assert [a + b for a, b in zip(outs[0]["rows"], outs[1]["rows"])] == want
    assert outs[0]["global"] == [[0, 1]] and outs[1]["global"] == [[2, 3]]
    assert outs[0]["local"] == outs[1]["local"] == [0, 1]
    # a tail of 2 rows divides over the 2 ranks
    assert [o["tail"] for o in outs] == ["accepted", "accepted"]
    assert [o["writer"] for o in outs] == [True, False]
    y0, y1 = (np.asarray(o["y"]) for o in outs)
    assert np.abs(y0 - y1).max() > 1e-3


def test_tail_that_does_not_divide_over_the_ranks_is_refused(tmp_path):
    """A drop_last=False tail of 1 row over 2 ranks raises at construction
    (10 rows in batches of 3), not at the epoch's last batch."""
    code = ("from weather_unet_tpu_torch.data.pipeline import BatchLoader\n"
            "from weather_unet_tpu_torch.parallel import launch\n"
            "launch.maybe_initialize()\n"
            "try:\n"
            "    BatchLoader(list(range(10)), 3, drop_last=False,"
            " process_shard=True)\n"
            "except ValueError as e:\n"
            "    assert 'tail batch (1 rows)' in str(e), e\n"
            "    print('REFUSED-OK')\n")
    rc = launch_ranks(2, [sys.executable, "-c", code], tmp_path / "logs",
                      timeout=120)
    assert rc == 0
    assert "REFUSED-OK" in rank_log(tmp_path / "logs", 1)


def test_weather_transfer_replicas_match_plain_and_jax(tmp_path):
    """A replica on each of two CPU devices: every entry point equals the
    one-device model (MAE <= 1e-6) and JAX's ``WeatherTransfer`` (< 1e-5);
    3 rows pad to 4, 2 a replica; fuse_upconv is refused with JAX's
    message."""
    from weather_unet_tpu.api import WeatherTransfer as JaxWeatherTransfer
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.models import ConditionalUNet
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    path = str(tmp_path / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                "global_step": 0}, path)
    plan = make_mesh(devices=["cpu", "cpu"])
    dp = WeatherTransfer.load(path, device="cpu", plan=plan)
    one = WeatherTransfer.load(path, device="cpu")
    seen = []
    for rep in dp._replicas:
        rep.register_forward_pre_hook(
            lambda m, a: seen.append(a[0].shape[0]))
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    c = np.eye(5, dtype=np.float32)[[0, 2, 4]]
    got = dp.translate(x, c)
    assert seen == [2, 2] and len(dp._replicas) == 2
    assert float((got - one.translate(x, c)).abs().mean()) <= 1e-6
    want = np.asarray(JaxWeatherTransfer.load(path).translate(x, c))
    assert float(np.abs(got.numpy() - want).mean()) < 1e-5
    u8 = rng.integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)
    assert torch.equal(dp.translate_u8(u8, c), one.translate_u8(u8, c))
    assert float((dp.translate_to_classes(x[:2])
                  - one.translate_to_classes(x[:2])).abs().max()) <= 1e-6

    def est(images):
        return torch.zeros(images.shape[0], 5)

    assert float((dp.sweep(x[:2], est, num_frames=3)
                  - one.sweep(x[:2], est, num_frames=3)).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="fuse_upconv serving is single-"):
        WeatherTransfer.load(path, device="cpu", plan=plan,
                             fuse_upconv=True)


def test_serve_data_parallel_answers(tmp_path):
    """``serve --data_parallel --device cpu``: a plan over the CPU, one
    replica, and a POST answered as the plain server answers it."""
    import threading
    import urllib.request

    from PIL import Image

    from weather_unet_tpu_torch.cli import serve
    from weather_unet_tpu_torch.models import ConditionalUNet

    torch.manual_seed(0)
    path = str(tmp_path / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                "global_step": 0}, path)
    buf = tmp_path / "x.jpg"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (32, 32, 3), np.uint8)).save(buf)
    body = buf.read_bytes()
    answers = []
    for extra in (["--data_parallel"], []):
        server = serve.build_server(serve.build_parser().parse_args(
            ["--cp_path", path, "--host", "127.0.0.1", "--port", "0",
             "--input_size", "32", "--device", "cpu", "--no-warmup"]
            + extra))
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            if extra:
                assert server.transfer.plan.mesh_shape == {"data": 1,
                                                           "model": 1}
            url = (f"http://127.0.0.1:{server.server_address[1]}"
                   "/translate?class=rain")
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                answers.append(resp.read())
        finally:
            server.shutdown()
            server.server_close()
            t.join(10)
    assert answers[0] == answers[1]
