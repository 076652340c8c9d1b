"""Tensor parallelism of the port on the CPU (``parallel/tp.py``), held to
the JAX package's unsharded functions and its ``tp_specs`` tree function at
the bars of ``tests/test_tensor_parallel.py``:

* the layout: the port's split of each state-dict key (parameters, ``u``,
  Adam's moments) against JAX's ``tp_specs`` of the cUNet's parameters
  and of the whole GAN state, through the converters' key maps, n = 1, 2,
  4; a degree that splits nothing and a plan without a model axis are
  refused with JAX's messages;
* in one process (``ThreadShards``): the cUNet over 2 and 4 CPU shards
  against JAX's forward (atol 1e-5, ``translate_u8`` within 1) with 7
  model-group sums a forward; the SNDisc with ``update_stats`` (out atol
  2e-4, the advanced ``u`` atol 1e-5);
* two or four gloo ranks in child processes (``tools/dp_train_torch.py``):
  the GAN step against one JAX step, the trainer through ``fit`` (cadence
  checkpoint, byte-equal ranks, a restore into the split), a checkpoint
  carried TP=2 -> 1 rank -> TP=4 -> data parallel, dropout masks and
  loader rows equal on the model ranks of a data row, a model axis
  without tensor parallelism holding replicas (both trainers), and
  ``train_transfer_est --tensor_parallel 2`` under the launcher;
* ``serve --tensor_parallel 2`` answering on two CPU shards.

Shapes 16²-32², f32, one torch thread a process; every multi-rank run is
bounded by 120 s."""

import copy
import shutil
import sys
import threading
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests.test_torch_data_parallel import (
    B, LR, SIZE, W, gan_kw, global_batches, jest, port_gan_state,
    rank_bytes, run_worker)
from tests.test_torch_gan import jax_sds, load_jax_state
from tests.torch_port_util import (  # noqa: F401
    launch_ranks, no_thread_left, one_torch_thread, rank_log)
from weather_unet_tpu.data.transforms import normalize_batch as jax_norm
from weather_unet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from weather_unet_tpu.parallel.tp import tp_specs as jax_tp_specs
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ConditionalUNet, SNDisc
from weather_unet_tpu_torch.parallel import tp
from weather_unet_tpu_torch.parallel.mesh import make_mesh
from weather_unet_tpu_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_state():
    cfg = jax_gan.GanConfig(input_size=32, batch_size=2, dropout_rate=0.0)
    return jax_gan.build_gan_state(cfg, jax.random.key(0))[2]


def shard_ids(shape, dim, n):
    """Each element's shard along ``dim`` (-1 everywhere for None)."""
    if dim is None:
        return np.full(shape, -1.0, np.float32)
    ids = np.arange(shape[dim]) // (shape[dim] // n)
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return np.broadcast_to(ids.reshape(view), shape).astype(np.float32)


def jax_markers(tree, specs, n):
    """A tree of ``tree``'s shapes whose leaves hold their shard ids under
    JAX's ``specs``."""
    def one(leaf, spec):
        shape = np.shape(leaf)
        dims = [i for i, a in enumerate(spec) if a == "model"]
        return shard_ids(shape, dims[0] if dims else None, n)

    return jax.tree.map(one, tree, specs)


def port_gan_nets():
    return (ConditionalUNet(5, generator=torch.Generator().manual_seed(0)),
            SNDisc(5, generator=torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_layout_is_jax_tp_specs_through_the_converters(jax_state, n):
    """Every state-dict key of both networks, their Adam moments and D's
    ``u`` split on the dimension JAX's ``tp_specs`` of the whole
    ``GanTrainState`` names (carried through ``compat/torch_io.py``'s key
    maps and transposes as shard-id markers); ``weight_v``, which JAX does
    not keep, is split with its conv2's input channels."""
    specs = jax_tp_specs(jax_state, n)
    marks = jax_markers(jax_state, specs, n)
    gen, disc = port_gan_nets()
    want = (tp.tp_specs(gen, n), tp.tp_specs(disc, n))
    for trees in (lambda ts: ts.params, lambda ts: ts.opt_state[1].mu,
                  lambda ts: ts.opt_state[1].nu):
        for sd, specs_port in zip(jax_sds(marks, trees), want):
            for key, dim in specs_port.items():
                if ".emb." in key or key.endswith("weight_v"):
                    continue        # not in JAX's tree (synthesized)
                np.testing.assert_array_equal(
                    sd[key], shard_ids(sd[key].shape, dim, n),
                    err_msg=f"n={n} {key}")
    d = want[1]
    if n == 2:
        assert d["conv2.0.weight_u"] == 0         # JAX's block2.conv1.u
        assert specs.spectral["block2"]["conv1"]["u"] == P("model")
        assert d["conv2.1.weight_v"] == 0 and d["conv2.0.weight_v"] is None
    for key in ("conv1.0.weight_u", "conv1.1.weight_u", "conv2.1.weight_u",
                "l.weight_u", "embed.weight_u", "conv_last.weight"):
        assert (d if key in d else want[0])[key] is None, key
    assert specs.spectral["linear"]["u"] == P()
    assert (tp.split_pairs(gen, n) != []) == (n > 1)


def test_refusals_carry_jax_messages(tmp_path):
    """A degree that splits no key of either network raises "NO leaf"
    (JAX's ``tp_shardings``); tensor parallelism without a model axis of 2
    raises JAX's guard, in the API and the trainer; a split model refuses
    fuse_upconv and takes the AOT tier (which captures nothing); spatial
    partitioning meets JAX's guard with JAX's message."""
    from weather_unet_tpu.api import WeatherTransfer as JaxWeatherTransfer
    from weather_unet_tpu.train.loops import (
        WeatherTransferTrainer as JaxTrainer)
    from weather_unet_tpu_torch.api import WeatherTransfer
    from weather_unet_tpu_torch.train.gan import GanConfig
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    gen, disc = port_gan_nets()
    with pytest.raises(ValueError, match="shards NO leaf") as e:
        tp.shard_gan_(gen, disc, tp.ThreadShards(["cpu"] * 7))
    assert "7-way tensor parallelism" in str(e.value)
    # 3 splits the SNDisc's 3 -> 3 -> 64 block alone, as in JAX
    assert tp.split_pairs(disc, 3) == [("conv1", "0", "1")]
    assert tp.split_pairs(gen, 3) == []
    with pytest.raises(ValueError, match="shards NO leaf"):
        WeatherTransfer(gen, plan=make_mesh(["cpu"] * 3, model=3),
                        tensor_parallel=True)

    with pytest.raises(ValueError) as jerr:
        JaxWeatherTransfer(None, None, tensor_parallel=True)
    for plan in (None, make_mesh(["cpu", "cpu"])):
        with pytest.raises(ValueError) as perr:
            WeatherTransfer(gen, device="cpu", plan=plan,
                            tensor_parallel=True)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jax_gan.GanConfig(input_size=16, batch_size=1),
                   lambda x: x, save_dir=str(tmp_path), tensor_parallel=True,
                   log_dir=str(tmp_path / "runs"))
    with pytest.raises(ValueError) as perr:
        WeatherTransferTrainer(GanConfig(input_size=16, batch_size=2),
                               lambda x: x.mean(dim=(2, 3)), device="cpu",
                               save_dir=str(tmp_path), tensor_parallel=True)
    assert str(perr.value) == str(jerr.value)

    two = make_mesh(["cpu", "cpu"], model=2)
    with pytest.raises(ValueError, match="fuse_upconv serving"):
        WeatherTransfer(ConditionalUNet(5, fuse_upconv=True), plan=two,
                        tensor_parallel=True)
    tiered = WeatherTransfer(ConditionalUNet(5), plan=two,
                             tensor_parallel=True,
                             aot_cache=str(tmp_path / "aot"))
    assert tiered.aot.stats["captures"] == 0
    with pytest.raises(ValueError) as perr:
        two.spatial(input_size=16)
    with pytest.raises(ValueError) as jerr:
        jax_make_mesh(jax.devices()[:2], model=2).spatial(input_size=16)
    assert "spatial partitioning degree 2" in str(perr.value)
    assert str(perr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def cunet_world(tmp_path_factory):
    """A seeded reference ``.pt``, inputs at 32², and JAX's unsharded
    forward of them (``WeatherTransfer.translate`` of the normalized
    uint8 images, and its uint8 wire by the same formulas)."""
    from weather_unet_tpu.api import WeatherTransfer as JaxWeatherTransfer

    d = tmp_path_factory.mktemp("cunet")
    torch.manual_seed(0)
    path = str(d / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                "global_step": 0}, path)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    x = ((u8.astype(np.float32) / 255.0) - 0.5) / 0.5
    c = np.eye(5, dtype=np.float32)[[0, 2, 4, 1]]
    y = np.asarray(JaxWeatherTransfer.load(path).translate(x, c))
    yield {"path": path, "u8": u8, "x": x, "c": c, "y": y,
           "y_u8": ((y + 1.0) * 127.5).clip(0, 255).astype(np.uint8)}
    shutil.rmtree(d, ignore_errors=True)


@pytest.mark.parametrize("n", [2, 4])
def test_cunet_split_forward_in_one_process_is_jax(cunet_world, n):
    """``WeatherTransfer`` over n CPU shards: each split pair's shard holds
    1/n of its conv1's output and conv2's input channels; translate within
    atol 1e-5 of JAX's unsharded forward, translate_u8 within 1, exactly 7
    model-group sums a forward; translate_to_classes and sweep equal the
    unsharded port's."""
    from weather_unet_tpu_torch.api import WeatherTransfer

    w = cunet_world
    wt = WeatherTransfer.load(w["path"], device="cpu", plan=make_mesh(
        ["cpu"] * n, model=n), tensor_parallel=True)
    one = WeatherTransfer.load(w["path"], device="cpu")
    assert len(wt._replicas) == n and len(wt._groups) == 1
    for shard in wt._replicas:
        assert shard.dconv_down1[0].weight.shape[0] == 64 // n
        assert shard.dconv_up1[2].weight.shape[1] == 64 // n
        assert shard.conv_last.weight.shape == (3, 64, 1, 1)
    group = wt._groups[0]
    got = wt.translate(w["x"], w["c"])
    assert group.pair_sums == group.sums == 7
    np.testing.assert_allclose(got.numpy(), w["y"], atol=1e-5)
    u8 = wt.translate_u8(w["u8"], w["c"]).numpy().astype(np.int16)
    assert np.abs(u8 - w["y_u8"].astype(np.int16)).max() <= 1
    assert group.pair_sums == 14
    assert float((wt.translate_to_classes(w["x"][:2])
                  - one.translate_to_classes(w["x"][:2])).abs().max()) < 1e-5

    def est(images):
        return torch.zeros(images.shape[0], 5)

    assert float((wt.sweep(w["x"][:2], est, num_frames=3)
                  - one.sweep(w["x"][:2], est, num_frames=3)).abs().max()
                 ) < 1e-5


def test_aot_tier_serves_the_split_model(cunet_world, tmp_path):
    """``aot_cache`` with ``tensor_parallel`` over two CPU shards: one
    program per shape and no capture; translate within MAE 1e-5 of JAX's
    tiered split ``WeatherTransfer`` and translate_u8 within 1 of its
    wire; both bit-equal to the port's untiered split."""
    from weather_unet_tpu.api import WeatherTransfer as JaxWeatherTransfer
    from weather_unet_tpu_torch.api import WeatherTransfer

    w = cunet_world
    jt = JaxWeatherTransfer.load(
        w["path"], plan=jax_make_mesh(jax.devices()[:2], model=2),
        tensor_parallel=True, aot_cache=str(tmp_path / "jax_aot"))
    want = np.asarray(jt.translate(w["x"], w["c"]))
    want_u8 = np.asarray(jt.translate_u8(w["u8"], w["c"])).astype(np.int16)
    plan = make_mesh(["cpu", "cpu"], model=2)
    tiered = WeatherTransfer.load(w["path"], device="cpu", plan=plan,
                                  tensor_parallel=True,
                                  aot_cache=str(tmp_path / "aot"))
    plain = WeatherTransfer.load(w["path"], device="cpu", plan=plan,
                                 tensor_parallel=True)
    got = tiered.translate(w["x"], w["c"])
    u8 = tiered.translate_u8(w["u8"], w["c"])
    assert float(np.abs(got.numpy() - want).mean()) < 1e-5
    assert np.abs(u8.numpy().astype(np.int16) - want_u8).max() <= 1
    assert torch.equal(got, plain.translate(w["x"], w["c"]))
    assert torch.equal(u8, plain.translate_u8(w["u8"], w["c"]))
    assert torch.equal(tiered.translate_to_classes(w["x"][:2]),
                       plain.translate_to_classes(w["x"][:2]))
    assert tiered.aot.stats["programs"] == 3
    assert tiered.aot.stats["captures"] == 0


def test_two_data_rows_of_two_shards(cunet_world):
    """``make_mesh(["cpu"] * 4, data=2, model=2)``: two rows of two shards,
    each row two of the four inputs, the whole within 1e-5 of JAX."""
    from weather_unet_tpu_torch.api import WeatherTransfer

    w = cunet_world
    wt = WeatherTransfer.load(w["path"], device="cpu", plan=make_mesh(
        ["cpu"] * 4, data=2, model=2), tensor_parallel=True)
    seen = []
    for shard in wt._replicas:
        shard.register_forward_pre_hook(
            lambda m, a: seen.append(a[0].shape[0]))
    got = wt.translate(w["x"], w["c"])
    assert sorted(seen) == [2, 2, 2, 2] and len(wt._groups) == 2
    assert [g.pair_sums for g in wt._groups] == [7, 7]
    np.testing.assert_allclose(got.numpy(), w["y"], atol=1e-5)


def test_sndisc_split_with_update_stats_is_jax():
    """The SNDisc over two CPU shards with ``update_stats``: the power
    iteration runs on the whole weights (sums of the shards' products),
    out within atol 2e-4 of JAX's unsharded forward and the advanced ``u``
    of block3's conv1 (split) and conv2 (whole) within 1e-5."""
    from weather_unet_tpu.models import SNDisc as JaxSNDisc

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    c = rng.standard_normal((4, 5)).astype(np.float32)
    jm = JaxSNDisc(num_classes=5)
    v = jm.init(jax.random.key(0), jnp.asarray(x[:1]), jnp.asarray(c[:1]))
    (ref, _), upd = jm.apply(v, jnp.asarray(x), jnp.asarray(c),
                             update_stats=True, mutable=["spectral"])
    whole = SNDisc(5)
    whole.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                           torch_io.sndisc_state_dict_from_jax(v).items()})
    group = tp.ThreadShards(["cpu", "cpu"])
    shards = []
    for i in range(2):
        shards.append(tp.shard_(copy.deepcopy(whole), group, index=i))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    outs = group.run(lambda i, dev: shards[i](xt, torch.from_numpy(c),
                                              update_stats=True)[0])
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=2e-4)
    u1 = torch.cat([s.conv3[0].weight_u for s in shards]).numpy()
    np.testing.assert_allclose(
        u1, np.asarray(upd["spectral"]["block3"]["conv1"]["u"]), atol=1e-5)
    np.testing.assert_allclose(
        shards[1].conv3[1].weight_u.numpy(),
        np.asarray(upd["spectral"]["block3"]["conv2"]["u"]), atol=1e-5)
    assert group.pair_sums == 3        # blocks 2-4; block1 (3 -> 3) whole


def test_shard_and_gather_state_round_trip():
    """``shard_state_dict`` then ``gather_state_dict`` gives back a whole
    GAN state dict bit for bit, Adam's moments by parameter name too."""
    gen, disc = port_gan_nets()
    for net in (gen, disc):
        sd = net.state_dict()
        specs = tp.tp_specs(net, 4)
        shards = [tp.shard_state_dict(sd, 4, i, specs) for i in range(4)]
        back = tp.gather_state_dict(shards, specs)
        assert list(back) == list(sd)
        assert all(torch.equal(back[k], sd[k]) for k in sd)
        moments = {n: {"exp_avg": p.detach() * 2, "step": torch.tensor(3.)}
                   for n, p in net.named_parameters()}
        net_split = tp.shard_(copy.deepcopy(net),
                              tp.ThreadShards(["cpu"] * 4), specs, index=3)
        mine = tp.shard_param_states(moments, net_split)
        for n, p in net_split.named_parameters():
            assert mine[n]["exp_avg"].shape == p.shape, n
            assert torch.equal(mine[n]["exp_avg"], p.detach() * 2), n
    assert tp.describe(2)["cUNet"]["shard_weight_bytes"] * 2 > (
        tp.describe(2)["cUNet"]["weight_bytes"])


def drop(*dirs):
    """Remove run directories once read: a GAN state is ~125 MB a file,
    and several tests' runs share the disk at once."""
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


def tp_run(tmp_path, name, n, extra):
    """``n`` ranks of the worker (a GAN run at 16², B=4) with ``extra``."""
    out = tmp_path / name
    recs = run_worker(tmp_path, out, [
        "--mode", "gan", "--size", str(SIZE), "--batch", str(B)] + extra,
        n=n)
    return out, recs


def gen_diffs(a, b):
    sa, sb = a.gen.module.state_dict(), b.gen.module.state_dict()
    return np.concatenate([(sa[k] - sb[k]).abs().numpy().ravel()
                           for k in sa if ".emb." not in k])


def test_gan_step_on_two_ranks_is_jax_step(tmp_path):
    """Two gloo ranks, ``data=1, model=2``, one GAN step at global B=4 from
    JAX's initial state: the ranks byte-equal; losses within rtol 1e-4 of
    JAX's unsharded step, G's parameters within 3·lr (max) and 1e-6
    (mean), D's ``u`` within 1e-4; the model-group sums counted."""
    jcfg = jax_gan.GanConfig(**gan_kw("est"))
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    cfg, gen, disc, state = port_gan_state("est")
    load_jax_state(state, jstate)
    cp = tmp_path / "cp"
    ckpt._write(ckpt.checkpoint_path(str(cp), "run", 0),
                ckpt._to_host(ckpt.gan_tree(state, 0)))
    out, recs = tp_run(tmp_path, "ranks", 2, [
        "--save_dir", str(cp), "--steps", "1", "--snapshots",
        "--tensor_parallel", "2", "--timing"])
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert rank_bytes(out, 0) == rank_bytes(out, 1)
    # each split pair sums once forward; the D step's 3 SN pairs also sum
    # their power iteration, sigma and the backward
    assert recs[0]["tp_sums"] == recs[1]["tp_sums"]
    assert recs[0]["tp_sums"][0] > 3 * 7
    import argparse
    args = argparse.Namespace(steps=1, batch=B, size=SIZE)
    (x, r), = global_batches(W.gan_loaders(args))
    lab = jnp.zeros(B, jnp.int32)
    js2, jm = jax.jit(lambda s, a, b, k: jax_gan.make_gan_step(
        jgen, jdisc, jest, jcfg)(s, a, lab, b, lab, k, do_g=True))(
        jstate, jax_norm(jnp.asarray(x)), jax_norm(jnp.asarray(r)),
        jax.random.key(1))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(recs[0]["metrics"][0][k], float(jm[k]),
                                   rtol=1e-4)
    _, _, _, got = port_gan_state("est", out / "rank0_s1.pt")
    want_g, want_d = jax_sds(js2)
    sg = got.gen.module.state_dict()
    diffs = np.concatenate([np.abs(sg[k].numpy() - np.asarray(want_g[k]))
                            .ravel() for k in want_g if ".emb." not in k])
    assert diffs.max() <= 3 * LR and diffs.mean() < 1e-6
    for k, v in got.disc.module.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), np.asarray(want_d[k]),
                                       atol=1e-4, err_msg=k)


def test_trainer_fit_checkpoints_and_restores_the_split(tmp_path):
    """The GAN trainer split over two ranks through ``fit``: the cadence
    checkpoint (every 2 steps) is the whole state, and the ranks gather
    byte-equal trees; it tracks the unsharded trainer (max 2·3·lr, mean
    1e-5); a relaunch resumes it into the split bit for bit (the state as
    built gathers to the file's bytes)."""
    cp = tmp_path / "cp"
    out, recs = tp_run(tmp_path, "tp", 2, [
        "--save_dir", str(cp), "--steps", "2", "--save_every", "2",
        "--tensor_parallel", "2"])
    path = ckpt.checkpoint_path(str(cp), "run", 2)
    with open(path, "rb") as f:
        saved = f.read()
    assert rank_bytes(out, 0) == rank_bytes(out, 1)
    tree = torch.load(path, weights_only=True)
    assert tree["gen"]["dconv_down1.0.weight"].shape[0] == 64
    assert tree["disc"]["conv2.0.weight_u"].shape == (64,)
    drop(out)
    ref, _ = tp_run(tmp_path, "one", 1, [
        "--save_dir", str(tmp_path / "cp1"), "--steps", "2"])
    diffs = gen_diffs(port_gan_state("est", ref / "rank0.pt")[3],
                      port_gan_state("est", path)[3])
    assert diffs.max() <= 2 * 3 * LR and diffs.mean() < 1e-5
    drop(ref, tmp_path / "cp1")
    again, _ = tp_run(tmp_path, "again", 2, [
        "--save_dir", str(cp), "--steps", "2", "--tensor_parallel", "2",
        "--save_start"])
    assert (again / "start.pt").read_bytes() == saved
    for r in (0, 1):
        assert "resumed from" in rank_log(tmp_path / "logs_again", r)


def test_checkpoint_carries_across_mesh_shapes(tmp_path):
    """A state trained 2 steps under TP=2 and stopped (SIGTERM: the
    preemption checkpoint) resumes bit for bit on one rank, under TP=4
    and data-parallel over two ranks, and each continuation's steps 3-4
    track the never-split 4-step run (max 4·3·lr, mean 3e-5)."""
    cp = tmp_path / "cp"
    drop(tp_run(tmp_path, "tp2", 2, ["--save_dir", str(cp), "--steps", "4",
                                     "--tensor_parallel", "2",
                                     "--stop_after", "2"])[0])
    path = ckpt.checkpoint_path(str(cp), "run", 2)
    saved = open(path, "rb").read()
    ref, _ = tp_run(tmp_path, "ref", 1, ["--save_dir", str(tmp_path / "r"),
                                         "--steps", "4"])
    want = port_gan_state("est", ref / "rank0.pt")[3]
    drop(ref, tmp_path / "r")
    for tag, n, extra in (("one", 1, []),
                          ("tp4", 4, ["--tensor_parallel", "4"]),
                          ("data", 2, [])):
        here = tmp_path / f"cp_{tag}"
        shutil.copytree(cp, here)
        out, recs = tp_run(tmp_path, tag, n, [
            "--save_dir", str(here), "--steps", "4", "--save_start"]
            + extra)
        assert (out / "start.pt").read_bytes() == saved, tag
        assert len(recs[0]["metrics"]) == 2, tag
        got = port_gan_state("est", out / "rank0.pt")[3]
        assert got.global_step == 4, tag
        diffs = gen_diffs(got, want)
        assert diffs.max() <= 4 * 3 * LR and diffs.mean() < 3e-5, tag
        drop(out, here)


def test_model_ranks_of_a_data_row_draw_the_same_rows_and_masks(tmp_path):
    """Four ranks, ``data=2, model=2``, at dropout 0.3: the two ranks of a
    data row load the same rows and their last decoder block sees the same
    dropped-out input, bit for bit (the masks key on the data index, not
    the rank); the two data rows load different rows and draw different
    masks."""
    out, _ = tp_run(tmp_path, "drop", 4, [
        "--save_dir", str(tmp_path / "cp"), "--steps", "1", "--dropout",
        "0.3", "--tensor_parallel", "2", "--dump_inputs",
        "--dump_activations"])
    rows = [torch.load(out / f"rank{r}_in1.pt", weights_only=True)
            for r in range(4)]
    acts = [torch.load(out / f"rank{r}_act.pt", weights_only=True)
            for r in range(4)]
    assert rows[0][0].shape[0] == B // 2
    for a, b in ((0, 1), (2, 3)):
        assert all(torch.equal(x, y) for x, y in zip(rows[a], rows[b]))
        assert torch.equal(acts[a], acts[b])
        assert 0.2 < float((acts[a] == 0).float().mean()) < 0.6
    assert not torch.equal(rows[0][0], rows[2][0])
    masks = [(a == 0) for a in acts]
    assert not torch.equal(masks[0], masks[2])


@pytest.mark.parametrize("mode", ["gan", "sup"])
def test_a_model_axis_without_tensor_parallel_holds_replicas(tmp_path,
                                                             mode):
    """``make_mesh(model=2)`` without ``tensor_parallel``, two ranks: each
    model position holds a full replica and steps on its data row's rows
    (the whole batch), as in the JAX package, so both ranks end
    byte-equal to one rank's run (the GAN trainer and
    ``train_supervised``)."""
    extra = (["--size", "32", "--batch", "4", "--steps", "2"]
             if mode == "sup" else ["--size", str(SIZE), "--batch", str(B),
                                    "--steps", "2"])
    runs = []
    for n, axis in ((2, ["--model_axis", "2"]), (1, [])):
        out = tmp_path / f"{mode}{n}"
        run_worker(tmp_path, out, ["--mode", mode, "--save_dir",
                                   str(tmp_path / f"cp{n}")] + extra + axis,
                   n=n)
        runs.append(out)
    assert rank_bytes(runs[0], 0) == rank_bytes(runs[0], 1) == rank_bytes(
        runs[1], 0)


def test_est_cli_tensor_parallel_under_the_launcher(tmp_path):
    """``train_transfer_est --tensor_parallel 2`` as two CPU ranks of the
    launcher for 2 steps: both end, the checkpoint holds the whole
    model."""
    from PIL import Image

    from weather_unet_tpu_torch.models import ResNet

    root = tmp_path / "img"
    root.mkdir()
    rng = np.random.default_rng(3)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), np.uint8)).save(
            root / f"{i}.jpg")
    est = tmp_path / "est.pt"
    torch.save(ResNet((1, 1, 1, 1), 5).state_dict(), est)
    cmd = [sys.executable, "-m",
           "weather_unet_tpu_torch.cli.train_transfer_est", "--image_root",
           str(root), "--estimator_path", str(est), "--image_only",
           "--input_size", "16", "--batch_size", "2", "--num_epoch", "1",
           "--num_workers", "1", "--save_dir", str(tmp_path / "cp"),
           "--log_dir", str(tmp_path / "runs"), "--tensor_parallel", "2",
           "--device", "cpu"]
    assert launch_ranks(2, cmd, tmp_path / "logs", timeout=120) == 0
    for r in (0, 1):
        assert "Done: training" in rank_log(tmp_path / "logs", r)
    path = ckpt.latest_checkpoint(str(tmp_path / "cp"), "cUNet")
    tree = torch.load(path, weights_only=True)
    assert tree["global_step"] == 2
    assert tree["gen"]["dconv_up1.2.weight"].shape == (64, 64, 3, 3)


def test_serve_tensor_parallel_answers_on_two_cpu_shards(cunet_world):
    """``serve --tensor_parallel 2 --device cpu``: the transfer is split
    over two CPU shards and answers POSTs as the plain server does."""
    from PIL import Image
    import io

    from weather_unet_tpu_torch.cli import serve

    buf = io.BytesIO()
    Image.fromarray(cunet_world["u8"][0]).save(buf, format="PNG")
    body = buf.getvalue()
    answers = []
    for extra in (["--tensor_parallel", "2"], []):
        server = serve.build_server(serve.build_parser().parse_args(
            ["--cp_path", cunet_world["path"], "--host", "127.0.0.1",
             "--port", "0", "--input_size", "32", "--device", "cpu",
             "--no-warmup"] + extra))
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            if extra:
                assert server.transfer.plan.mesh_shape == {"data": 1,
                                                           "model": 2}
                assert server.transfer.tensor_parallel
            url = (f"http://127.0.0.1:{server.server_address[1]}"
                   "/translate?class=rain")
            got = []
            for _ in range(2):
                req = urllib.request.Request(url, data=body, method="POST")
                with urllib.request.urlopen(req, timeout=60) as resp:
                    assert resp.status == 200
                    got.append(np.asarray(Image.open(io.BytesIO(
                        resp.read()))).astype(np.int16))
            answers.append(got[0])
        finally:
            server.shutdown()
            server.server_close()
            t.join(10)
    # uint8 outputs within one step, then JPEG-encoded
    assert np.abs(answers[0] - answers[1]).mean() < 1.0


def test_serve_tensor_parallel_with_aot_cache(cunet_world, tmp_path):
    """``serve --tensor_parallel 2 --aot_cache D --device cpu`` answers on
    two CPU shards with the bytes of the untiered split server."""
    from PIL import Image
    import io

    from weather_unet_tpu_torch.cli import serve

    buf = io.BytesIO()
    Image.fromarray(cunet_world["u8"][1]).save(buf, format="PNG")
    body = buf.getvalue()
    answers = []
    for extra in (["--aot_cache", str(tmp_path / "aot")], []):
        server = serve.build_server(serve.build_parser().parse_args(
            ["--cp_path", cunet_world["path"], "--host", "127.0.0.1",
             "--port", "0", "--input_size", "32", "--device", "cpu",
             "--no-warmup", "--tensor_parallel", "2"] + extra))
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            assert (server.transfer.aot is not None) == bool(extra)
            url = (f"http://127.0.0.1:{server.server_address[1]}"
                   "/translate?class=snow")
            req = urllib.request.Request(url, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                assert resp.status == 200
                answers.append(resp.read())
            if extra:
                assert server.transfer.aot.stats["captures"] == 0
                assert server.transfer.aot.stats["programs"] >= 1
        finally:
            server.shutdown()
            server.server_close()
            t.join(10)
    assert answers[0] == answers[1]
