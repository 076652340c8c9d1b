"""The frozen ResNet estimator and the GAN evaluation step over spatial
shards (``parallel/spatial.py::EstimatorRows``, ``mesh.estimator_cut``,
``train/gan.py::make_eval_step``) on the CPU, held to the JAX package:

* the estimator's cut at multiples of 32 (the trailing shards hold no rows
  where the degree exceeds H/32), the cUNet's cut unchanged, the refusals;
* (a) the eval step over 2 and 4 in-process shards, 64², B=4, 4 reference
  conditions, dropout 0, a marked ResNet(2, 2, 2, 2) as the estimator,
  against JAX's eval step jitted with its images on ``plan.spatial()``
  (losses rtol 2e-4 + atol 1e-5, the fakes atol 1e-5) and against the
  port's one-process eval step at the same bars;
* (b) the marked ResNet, 64², B=2, over 2 shards and over 4 (two of them
  without rows): logits within 2e-4 * max(1, max|logits|) of
  ``ResNet.apply`` jitted under ``plan.spatial()``, the input gradient of a
  scalar of the logits within 1e-5 of its largest element against
  ``jax.grad`` of the unsharded module, every shard keeping its cut's rows;
* (c) the re-cut from the cUNet's 16-row cut, 96² over 2 shards (48/48
  becomes 64/32): values and gradients within 1e-6 of the unsharded port;
* (d) the K4 route over a marked module (plain K4 on the CPU) against
  JAX's unsharded ``fused_resnet_eval(interpret=True)``;
* (e) one GAN step on two gloo ranks with the marked ResNet through the K4
  route, against JAX's step jitted with its images on ``plan.spatial()``
  and the ResNet's ``apply`` as ``est_apply`` (losses rtol 1e-4, JAX's
  test's leaf atol 1e-5, G max 3·lr, mean 1e-6, ``u`` 1e-4).

In-process shards with autograd are ``tests/test_torch_spatial.py``'s
``GradThreadShards``; each shard backpropagates the replicated scalar
divided by the degree, as the GAN step does.  One torch thread; the
multi-rank run is bounded by 120 s and every directory deleted once read."""

import copy
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_data_parallel import LR, rank_bytes, run_worker
from tests.test_torch_gan import jax_sds, load_jax_state
from tests.test_torch_resnet import jax_resnet_variables, port_resnet
from tests.test_torch_spatial import GradThreadShards, nchw, shard_rows
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.kernels import bottleneck_pallas as jax_k4
from weather_unet_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.cli.common import load_step_estimator
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.kernels import bottleneck as k4
from weather_unet_tpu_torch.models import ResNet
from weather_unet_tpu_torch.parallel import spatial, tp
from weather_unet_tpu_torch.parallel.mesh import estimator_cut, row_cut
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_eval_step)

COUNTS = (2, 2, 2, 2)
SIZE = 64


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def resnet():
    """JAX's ResNet(2, 2, 2, 2) with randomized BatchNorms, its variables
    and the port's frozen copy."""
    model, v = jax_resnet_variables(COUNTS, num_classes=5, size=SIZE)
    est = port_resnet(v, COUNTS, 5).eval().requires_grad_(False)
    return model, v, est


def jax_plan(n, data=2):
    devs = np.asarray(jax.devices()[:data * n]).reshape(data, n)
    return JaxMeshPlan(Mesh(devs, ("data", "model")))


def logits_close(got, want):
    tol = 2e-4 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(np.asarray(got) - want).max()) <= tol


def test_estimator_cut_and_refusals():
    """The estimator's cut: multiples of 32 as even as ``row_cut`` makes
    them, the larger shards first, the trailing shards without rows where
    the degree exceeds H/32; ``row_cut`` as it was; a ResNet is refused at
    a height that is no multiple of 32, a marked estimator beside unmarked
    networks, train-mode BatchNorm before any exchange."""
    assert estimator_cut(224, 2) == [(0, 128), (128, 96)]
    assert estimator_cut(224, 4) == [(0, 64), (64, 64), (128, 64),
                                     (192, 32)]
    assert estimator_cut(64, 4) == [(0, 32), (32, 32), (64, 0), (64, 0)]
    assert estimator_cut(96, 2) == [(0, 64), (64, 32)]
    assert estimator_cut(224, 14) == [(32 * k, 32) for k in range(7)] + [
        (224, 0)] * 7
    assert row_cut(224, 4) == [(0, 48), (48, 64), (112, 48), (160, 64)]
    with pytest.raises(ValueError, match="deepest stride 32"):
        estimator_cut(48, 2)
    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * 2), 48)
    with pytest.raises(ValueError, match="multiple of 32 rows"):
        spatial.spatial_(ResNet((1, 1, 1, 1), 5), group, 0)
    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * 2), 32)
    est = spatial.spatial_(ResNet((1, 1, 1, 1), 5).eval(), group, 0)
    assert est.sp is group.estimator_view() and spatial.group_of(est) is (
        group)
    gen, disc, _ = build_gan_state(GanConfig(input_size=32, batch_size=2),
                                   0, "cpu")
    with pytest.raises(ValueError, match="its own group"):
        make_eval_step(gen, disc, est, GanConfig(input_size=32))
    with pytest.raises(ValueError, match="eval mode"):
        est.train()(torch.zeros(1, 3, 16, 32))


def shard_states(state, est, group, n):
    """Each shard's copy of the GAN state and of the estimator, marked."""
    out = []
    for i in range(n):
        st = copy.deepcopy(state)
        spatial.spatial_(st.gen.module, group, i)
        spatial.spatial_(st.disc.module, group, i)
        out.append((st, spatial.spatial_(copy.deepcopy(est), group, i)))
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_eval_step_on_shards_is_jax_spatial_jit(resnet, n):
    """(a) Over n in-process shards (the marked ResNet: at n = 4 two shards
    hold no estimator rows), 64², B=4, 4 reference conditions, dropout 0:
    every shard's metrics within rtol 2e-4 + atol 1e-5 of JAX's eval step
    jitted with its images on ``plan.spatial()`` (2 x n devices) and of
    the port's one-process eval step, the shards' fakes joined within atol
    1e-5 of both, each shard holding its own rows."""
    jres, rv, est = resnet
    jcfg = jax_gan.GanConfig(input_size=SIZE, batch_size=4, dropout_rate=0.0,
                             lr=LR, num_epoch=1)
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    cfg = GanConfig(input_size=SIZE, batch_size=4, dropout_rate=0.0, lr=LR,
                    num_epoch=1)
    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    load_jax_state(state, jstate)
    rng = np.random.default_rng(30 + n)
    x = rng.uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.standard_normal((4, 5)).astype(np.float32)
    refs = rng.standard_normal((4, 5)).astype(np.float32)

    jplan = jax_plan(n)
    rep, xsh = jplan.replicated(), jplan.spatial()
    # the estimator's variables are an argument: closed over as constants,
    # JAX's partitioner put the ResNet's logits 0.92 away from unsharded
    # on this 2 x 2 mesh (on 1 x 2 within 6e-7)
    f = jax.jit(lambda v, *a: jax_gan.make_eval_step(
        jgen, jdisc, lambda im: jres.apply(v, im, train=False), jcfg)(*a),
        in_shardings=(rep, rep, xsh, jplan.batch(), rep, rep))
    jm, jfakes = f(jax.device_put(rv, rep), jax.device_put(jstate, rep),
                   jax.device_put(x, xsh),
                   jax.device_put(labels, jplan.batch()),
                   jax.device_put(refs, rep), jax.random.key(0))
    jfakes = np.asarray(jfakes).transpose(0, 1, 4, 2, 3)  # NHWC -> NCHW

    one_m, one_fakes = make_eval_step(gen, disc, est, cfg)(
        state, nchw(x), torch.from_numpy(labels), torch.from_numpy(refs),
        torch.Generator().manual_seed(0))

    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * n), SIZE)
    shards = shard_states(state, est, group, n)
    steps = [make_eval_step(st.gen.module, st.disc.module, e, cfg)
             for st, e in shards]
    res = group.shards.run(lambda i, dev: steps[i](
        shards[i][0], shard_rows(nchw(x), group, i),
        torch.from_numpy(labels), torch.from_numpy(refs),
        torch.Generator().manual_seed(0)))
    assert [r[1].shape[3] for r in res] == [rows for _, rows in group.cut]
    fakes = torch.cat([r[1] for r in res], dim=3).numpy()
    for m, _ in res:
        assert set(m) == set(jm)
        for k in jm:
            for want in (float(jm[k]), float(one_m[k])):
                np.testing.assert_allclose(float(m[k]), want, rtol=2e-4,
                                           atol=1e-5, err_msg=k)
    np.testing.assert_allclose(fakes, jfakes, atol=1e-5)
    np.testing.assert_allclose(fakes, one_fakes.numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_marked_resnet_is_jax_spatial_apply(resnet, n):
    """(b) The marked ResNet over n shards with autograd, 64², B=2 (at n =
    4 the cut is 32/32/0/0): the logits, equal on every shard, within
    2e-4 * max(1, max|logits|) of JAX's apply jitted with its images on
    ``plan.spatial()``; the input gradient of sum(logits * w) within 1e-5
    of its largest element against ``jax.grad`` of the unsharded module;
    each shard keeps its cut's rows of the images, none more."""
    jres, rv, est = resnet
    rng = np.random.default_rng(40 + n)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    w = rng.standard_normal((2, 5)).astype(np.float32)
    jplan = jax_plan(n)
    rep, xsh = jplan.replicated(), jplan.spatial()
    want = np.asarray(jax.jit(lambda v, im: jres.apply(v, im, train=False),
                              in_shardings=(rep, xsh))(
        jax.device_put(rv, rep), jax.device_put(x, xsh)))
    gx_want = np.asarray(jax.grad(lambda im: jnp.sum(
        jres.apply(rv, im, train=False) * w))(jnp.asarray(x)))

    group = spatial.SpatialGroup(GradThreadShards(["cpu"] * n), SIZE)
    shards = [spatial.spatial_(copy.deepcopy(est), group, i)
              for i in range(n)]

    def one(i, dev):
        xi = shard_rows(nchw(x), group, i).requires_grad_()
        out = shards[i](xi)
        (gx,) = torch.autograd.grad(out, [xi], torch.from_numpy(w) / n)
        return out.detach(), gx

    res = group.shards.run(one)
    view = group.estimator_view()
    assert view.input_rows == {i: rows for i, (_, rows) in
                               enumerate(view.cut)}
    for out, _ in res:
        assert torch.equal(out, res[0][0])
    logits_close(res[0][0].numpy(), want)
    gx = torch.cat([r[1] for r in res], dim=2).permute(0, 2, 3, 1).numpy()
    assert np.abs(gx - gx_want).max() <= 1e-5 * np.abs(gx_want).max()


def test_recut_from_the_cunet_cut(resnet):
    """(c) 96² over 2 shards: the cUNet's 48/48 re-cut to the estimator's
    64/32; the logits and the input gradient (joined over the cUNet's
    cut) within 1e-6 of the unsharded port's."""
    _, _, est = resnet
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 96, 96)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    xr = x.clone().requires_grad_()
    want = est(xr)
    (gx_want,) = torch.autograd.grad(want, [xr], w)
    group = spatial.SpatialGroup(GradThreadShards(["cpu"] * 2), 96)
    assert group.cut == [(0, 48), (48, 48)]
    assert group.estimator_view().cut == [(0, 64), (64, 32)]
    shards = [spatial.spatial_(copy.deepcopy(est), group, i)
              for i in range(2)]

    def one(i, dev):
        xi = shard_rows(x, group, i).requires_grad_()
        out = shards[i](xi)
        return out.detach(), torch.autograd.grad(out, [xi], w / 2)[0]

    res = group.shards.run(one)
    assert group.estimator_view().input_rows == {0: 64, 1: 32}
    for out, _ in res:
        np.testing.assert_allclose(out.numpy(), want.detach().numpy(),
                                   atol=1e-6)
    gx = torch.cat([r[1] for r in res], dim=2)
    np.testing.assert_allclose(gx.numpy(), gx_want.numpy(), atol=1e-6)


def test_k4_route_over_a_marked_module(resnet, tmp_path, monkeypatch):
    """(d) ``load_step_estimator(route="k4")`` with its module marked, over
    2 shards: without autograd each shard gathers the rows once and runs
    ``fused_resnet_eval`` whole (K4's plain version here: its 4 identity
    blocks a forward see whole images), within 2e-4 * max(1, max|logits|)
    of JAX's unsharded ``fused_resnet_eval(interpret=True)``; with autograd
    the route's logits come from the split module (a graph, the module's
    values).

    The reference is JAX's unsharded fused route: jitted with its input on
    ``plan.spatial()``, JAX's interpreted Pallas K4 treats each shard's
    rows as a whole image and lands 0.44 from its own unsharded output (on
    a TPU the partitioner would gather the operands), so JAX's sharded K4
    route is no reference."""
    _, rv, est = resnet
    path = tmp_path / "est.pt"
    torch.save(est.state_dict(), path)
    rng = np.random.default_rng(60)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax_k4.fused_resnet_eval(
        rv, block_counts=COUNTS, interpret=True)(jnp.asarray(x)))
    seen = []
    fused = k4.fused_bottleneck_eval

    def spy(xb, *a, **k):
        seen.append(tuple(xb.shape))
        return fused(xb, *a, **k)

    monkeypatch.setattr(k4, "fused_bottleneck_eval", spy)
    for shards in (tp.ThreadShards(["cpu"] * 2), GradThreadShards(
            ["cpu"] * 2)):
        group = spatial.SpatialGroup(shards, SIZE)
        routes = [load_step_estimator(str(path), device="cpu", route="k4")
                  for _ in range(2)]
        for i, r in enumerate(routes):
            spatial.spatial_(r.model, group, i)
        outs = group.shards.run(lambda i, dev: routes[i](
            shard_rows(nchw(x), group, i).requires_grad_()))
        for out in outs:
            logits_close(out.detach().numpy(), want)
        if isinstance(shards, GradThreadShards):
            assert all(out.requires_grad for out in outs)
        else:
            assert sorted(seen) == sorted([(2, 256, 16, 16),
                                           (2, 512, 8, 8), (2, 1024, 4, 4),
                                           (2, 2048, 2, 2)] * 2)
            seen.clear()
    assert seen == []


def test_gan_step_on_two_ranks_with_a_marked_resnet(resnet, tmp_path):
    """(e) Two gloo ranks of ``tools/dp_train_torch.py --spatial 2`` (32
    rows each, the estimator 32/32) with the ResNet marked through the K4
    route, one combined GAN step at 64², B=2 from JAX's initial state,
    against JAX's step jitted with its images on ``plan.spatial()`` and
    the ResNet's apply as ``est_apply``: the ranks byte-equal and their
    eval steps equal; d_loss and g_loss within rtol 1e-4; the leaf JAX's
    own test holds within atol 1e-5; every G parameter within the Adam
    sign-flip bound (max 3·lr, mean 1e-6); D's ``u`` within 1e-4."""
    jres, rv, est = resnet
    jcfg = jax_gan.GanConfig(input_size=SIZE, batch_size=2, dropout_rate=0.0,
                             lr=LR, num_epoch=1)
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    cfg = GanConfig(input_size=SIZE, batch_size=2, dropout_rate=0.0, lr=LR,
                    num_epoch=1)
    _, _, state = build_gan_state(cfg, 0, "cpu")
    load_jax_state(state, jstate)
    init, est_path = tmp_path / "init.pt", tmp_path / "est.pt"
    with open(init, "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
    torch.save(est.state_dict(), est_path)
    out = tmp_path / "ranks"
    recs = run_worker(tmp_path, out, [
        "--mode", "gan", "--spatial", "2", "--size", str(SIZE), "--batch",
        "2", "--steps", "1", "--init", str(init), "--estimator_path",
        str(est_path), "--route", "k4", "--dump_inputs", "--device", "cpu"])
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert recs[0]["eval"]["metrics"] == recs[1]["eval"]["metrics"]
    assert [r["estimator_input_rows"] for r in recs] == [32, 32]
    assert rank_bytes(out, 0) == rank_bytes(out, 1)
    ins = [torch.load(out / f"rank{r}_in1.pt", weights_only=True)
           for r in range(2)]
    x, r = (torch.cat([ins[0][k], ins[1][k]], dim=2).permute(0, 2, 3, 1)
            .numpy() for k in (0, 2))
    lab = jnp.zeros(2, jnp.int32)
    jplan = jax_plan(2, data=1)
    rep, xsh = jplan.replicated(), jplan.spatial()
    js2, jm = jax.jit(lambda v, s, a, b, k: jax_gan.make_gan_step(
        jgen, jdisc, lambda im: jres.apply(v, im, train=False), jcfg)(
        s, a, lab, b, lab, k, do_g=True),
        in_shardings=(rep, rep, xsh, xsh, rep))(
        jax.device_put(rv, rep), jax.device_put(jstate, rep),
        jax.device_put(x, xsh), jax.device_put(r, xsh), jax.random.key(1))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(recs[0]["metrics"][0][k], float(jm[k]),
                                   rtol=1e-4)
    _, _, got = build_gan_state(cfg, 0, "cpu")
    ckpt.restore_checkpoint(str(out / "rank0.pt"), got)
    want_g, want_d = jax_sds(js2)
    sg = got.gen.module.state_dict()
    leaves, treedef = jax.tree.flatten(js2.gen.params)
    marks = torch_io.cunet_state_dict_from_jax({"params": jax.tree.unflatten(
        treedef, [np.full(np.shape(a), i + 1.0, np.float32)
                  for i, a in enumerate(leaves)])})
    name = next(k for k, a in marks.items() if np.all(np.asarray(a) == 1))
    np.testing.assert_allclose(sg[name].numpy(), np.asarray(want_g[name]),
                               atol=1e-5, err_msg=name)
    diffs = np.concatenate([np.abs(sg[k].numpy() - np.asarray(want_g[k]))
                            .ravel() for k in want_g if ".emb." not in k])
    assert diffs.max() <= 3 * LR and diffs.mean() < 1e-6
    for k, v in got.disc.module.state_dict().items():
        if k.endswith("weight_u"):
            np.testing.assert_allclose(v.numpy(), np.asarray(want_d[k]),
                                       atol=1e-4, err_msg=k)
    shutil.rmtree(out, ignore_errors=True)
