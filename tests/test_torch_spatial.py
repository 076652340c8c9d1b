"""Spatial partitioning of the port on the CPU (``parallel/spatial.py``,
``MeshPlan.spatial``), held to the JAX package at the bars of
``tests/test_spatial_partition.py``:

* ``MeshPlan.spatial``'s guard with JAX's message, the row cut at
  multiples of the deepest stride, and the placement of NHWC images
  against JAX's shards of ``P("data", "model", None, None)``;
* in one process (``ThreadShards``): the cUNet forward over 2 and 4 CPU
  shards of two data rows against JAX's spatially sharded ``jit`` (atol
  1e-5, 64²), the uneven cut (48², 16 + 32 rows), the SNDisc with
  ``update_stats`` (out atol 2e-4, ``u`` atol 1e-5), dropout masks that
  are the unsharded mask's rows;
* the plain apply step (``adain_from_shard_stats``) and K1's apply op on
  CPU tensors against the merge, then the modulation, bit for bit, for 2,
  3 and 4 uneven shards;
* the split AdaIN and the row-window upsample, plain and through K1's /
  K2's registered ops (their CPU forms), values and gradients against
  JAX's ``ops.norm.adain`` and ``ops.resize`` over three uneven shards
  (a ``ThreadShards`` with autograd kept on, built here: each shard's
  backward meets the others'), and K2's staging mirror inside the halo;
* the combined GAN step on two gloo ranks (``tools/dp_train_torch.py
  --spatial 2``) at 32² against one JAX step (losses rtol 1e-4, JAX's
  test's parameter leaf atol 1e-5, every parameter within the Adam
  sign-flip bound, ``u`` atol 1e-4, the ranks byte-equal);
* the refusals.

Shapes 32²-64², f32, one torch thread; the multi-rank run is bounded by
120 s and its directory deleted once read."""

import copy
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_data_parallel import LR, jest, rank_bytes, run_worker
from tests.test_torch_gan import jax_sds, load_jax_state
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.models import ConditionalUNet as JaxCUNet
from weather_unet_tpu.models import SNDisc as JaxSNDisc
from weather_unet_tpu.ops.norm import adain as jax_adain
from weather_unet_tpu.ops.resize import (
    upsample_bilinear_align_corners as jax_upsample)
from weather_unet_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from weather_unet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet, SNDisc
from weather_unet_tpu_torch.parallel import spatial, tp
from weather_unet_tpu_torch.parallel.mesh import (
    make_mesh, put_host_local, row_cut)
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)


@pytest.fixture(autouse=True)
def drop_tmp(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def shard_rows(x, group, index):
    """Shard ``index``'s rows (dim 2) of a whole NCHW batch."""
    start, rows = group.cut[index]
    return x.narrow(2, start, rows).contiguous()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def test_guard_row_cut_and_placement_match_jax():
    """The guard raises JAX's ValueError with JAX's message wherever JAX
    does; rows are cut at multiples of the stride, as evenly as that
    allows; a 2 x 4 plan places each device's NHWC shard as JAX's
    ``P("data", "model", None, None)`` does where the cut is even."""
    for n in (1, 2, 4):
        for size in (16, 32, 48, 64, 128, 224):
            for stride in (16, 8):
                got = want = None
                try:
                    jax_make_mesh(jax.devices()[:n], model=n).spatial(
                        input_size=size, deepest_stride=stride)
                except ValueError as e:
                    want = str(e)
                try:
                    make_mesh(["cpu"] * n, model=n).spatial(
                        input_size=size, deepest_stride=stride)
                except ValueError as e:
                    got = str(e)
                assert got == want, (n, size, stride)
    assert make_mesh(["cpu"] * 4, model=4).spatial().spec == (
        "data", "model")
    assert row_cut(224, 4) == [(0, 48), (48, 64), (112, 48), (160, 64)]
    assert row_cut(48, 2) == [(0, 16), (16, 32)]
    assert row_cut(64, 4) == [(0, 16), (16, 16), (32, 16), (48, 16)]
    with pytest.raises(ValueError, match="whole multiples of 16"):
        row_cut(40, 2)

    devs = np.asarray(jax.devices()[:8]).reshape(2, 4)
    jplan = JaxMeshPlan(Mesh(devs, ("data", "model")))
    x = np.random.default_rng(0).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    placed = jax.device_put(x, jplan.spatial())
    shards = {s.device: np.asarray(s.data)
              for s in placed.addressable_shards}
    parts = put_host_local(make_mesh(["cpu"] * 8, data=2, model=4)
                           .spatial(input_size=64), x)
    assert len(parts) == 8
    for k, dev in enumerate(devs.reshape(-1)):
        np.testing.assert_array_equal(parts[k].numpy(), shards[dev])


@pytest.fixture(scope="module")
def cunet_vars():
    model = JaxCUNet(num_classes=5)
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    v = model.init(jax.random.key(0), x, jnp.zeros((1, 5), jnp.float32))
    port = ConditionalUNet(5)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          torch_io.cunet_state_dict_from_jax(v).items()},
                         strict=False)
    return model, v, port.eval()


@pytest.mark.parametrize("n", [2, 4])
def test_cunet_forward_on_shards_is_jax_spatial_jit(cunet_vars, n):
    """Two data rows of n CPU shards, 64²: the port's forward within atol
    1e-5 of JAX's jit with the images placed by ``plan.spatial()`` (as
    ``tests/test_spatial_partition.py``), 20 exchanges a forward (14 conv
    halos, 3 split statistics, 3 upsample halos)."""
    model, v, port = cunet_vars
    rng = np.random.default_rng(n)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    c = rng.standard_normal((4, 5)).astype(np.float32)
    devs = np.asarray(jax.devices()[:2 * n]).reshape(2, n)
    jplan = JaxMeshPlan(Mesh(devs, ("data", "model")))
    xsh, rsh, csh = jplan.spatial(), jplan.replicated(), jplan.batch()
    f = jax.jit(lambda v, x, c: model.apply(v, x, c),
                in_shardings=(rsh, xsh, csh), out_shardings=xsh)
    want = np.asarray(f(jax.device_put(v, rsh), jax.device_put(x, xsh),
                        jax.device_put(c, csh)))
    plan = make_mesh(["cpu"] * (2 * n), data=2, model=n)
    sm = spatial.SpatialModel(port, plan, 64)
    outs = sm(put_host_local(plan.spatial(input_size=64), x),
              torch.from_numpy(c), batched=[True])
    assert [o.shape[1] for o in outs] == [64 // n] * (2 * n)
    np.testing.assert_allclose(sm.join(outs).numpy(), want, atol=1e-5)
    assert [g.exchanges for g in sm.groups] == [20, 20]


def test_uneven_cut_forward(cunet_vars):
    """48², degree 2: rows 16 + 32 (every level whole), within atol 1e-5 of
    JAX's unsharded forward."""
    model, v, port = cunet_vars
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 48, 48, 3)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    want = np.asarray(model.apply(v, jnp.asarray(x), jnp.asarray(c)))
    plan = make_mesh(["cpu"] * 2, model=2)
    parts = put_host_local(plan.spatial(input_size=48), x)
    assert [p.shape[1] for p in parts] == [16, 32]
    sm = spatial.SpatialModel(port, plan, 48)
    got = sm.join(sm(parts, torch.from_numpy(c)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_sndisc_with_update_stats_is_jax():
    """The SNDisc over two CPU shards of 16 rows with ``update_stats``: the
    logits (the global sum pool summed over the shards) within atol 2e-4
    of JAX's unsharded forward, equal on both shards, and every advanced
    ``u`` within 1e-5 (the weights are replicated)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    jm = JaxSNDisc(num_classes=5)
    v = jm.init(jax.random.key(0), jnp.asarray(x[:1]), jnp.asarray(c[:1]))
    (ref, _), upd = jm.apply(v, jnp.asarray(x), jnp.asarray(c),
                             update_stats=True, mutable=["spectral"])
    whole = SNDisc(5)
    whole.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                           torch_io.sndisc_state_dict_from_jax(v).items()})
    plan = make_mesh(["cpu"] * 2, model=2)
    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * 2), 32)
    shards = [spatial.spatial_(copy.deepcopy(whole), group, i)
              for i in range(2)]
    parts = put_host_local(plan.spatial(input_size=32), x)
    outs = group.shards.run(lambda i, dev: shards[i](
        parts[i].permute(0, 3, 1, 2).contiguous(), torch.from_numpy(c),
        update_stats=True)[0])
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(ref), atol=2e-4)
    want_u = torch_io.sndisc_state_dict_from_jax(
        {"params": v["params"], "spectral": upd["spectral"]})
    for s in shards:
        for k, u in s.state_dict().items():
            if k.endswith("weight_u"):
                np.testing.assert_allclose(u.numpy(), np.asarray(want_u[k]),
                                           atol=1e-5, err_msg=k)


class GradThreadShards(tp.ThreadShards):
    """In-process CPU shards that take part in autograd: each shard's
    function runs with grad on, and a CPU backward runs on the thread that
    calls it, so each shard's backward meets the others' as its forward
    did.  The sums' and gathers' backwards are the spatial group's."""

    def run(self, fn):
        def with_grad(i, dev):
            with torch.enable_grad():
                return fn(i, dev)

        return super().run(with_grad)

    def _sum(self, t):
        return super()._sum(t.detach())


def three_shards(height, unit=8):
    """Three in-process CPU shards that take part in autograd, over images
    of ``height`` rows cut at multiples of ``unit`` (40 rows: 8/16/16)."""
    return spatial.SpatialGroup(GradThreadShards(["cpu"] * 3), height, unit)


def run_rows(group, x, g, fn, extra):
    """Each shard's ``fn(rows, *extra)`` and its gradient for the cotangent
    ``g``'s rows (x NCHW whole, g the whole output's); returns (the
    output's rows joined, x's gradient joined, each extra's gradient
    summed over the shards: a replicated input's gradient is each shard's
    share)."""
    def one(i, dev):
        xi = shard_rows(x, group, i).requires_grad_()
        ex = [e.clone().requires_grad_() for e in extra]
        out = fn(xi, *ex)
        start, total = group.level(xi.shape[2])
        rows = out.shape[2]
        gi = g.narrow(2, start * rows // xi.shape[2], rows)
        grads = torch.autograd.grad(out, [xi, *ex], gi)
        return out.detach(), grads
    res = group.shards.run(one)
    out = torch.cat([r[0] for r in res], dim=2)
    gx = torch.cat([r[1][0] for r in res], dim=2)
    gex = [sum(r[1][1 + k] for r in res) for k in range(len(extra))]
    return out, gx, gex


@pytest.mark.parametrize("use_pallas", [False, True])
def test_split_adain_values_and_gradients_are_jax(use_pallas):
    """AdaIN of 40-row planes over shards of 8, 16 and 16 rows, plain and
    through K1's split ops (``wut::adain_stats`` / ``wut::adain_apply``,
    their CPU forms): values within 1e-5 of JAX's ``adain`` of the whole
    planes, the gradients of x (at the shard edges too) and of y_proj
    within 1e-5 of ``jax.vjp``'s."""
    group = three_shards(40)
    assert group.cut == [(0, 8), (8, 16), (24, 16)]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 7, 6)).astype(np.float32) * 2 + 0.5
    y = rng.standard_normal((2, 24)).astype(np.float32)
    g = rng.standard_normal((2, 40, 7, 6)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: jax_adain(a, b), jnp.asarray(x),
                        jnp.asarray(y))
    gx_want, gy_want = vjp(jnp.asarray(g))
    out, gx, (gy,) = run_rows(
        group, nchw(x), nchw(g),
        lambda xi, yi: group.adain(xi, yi, 1e-5, use_pallas),
        [torch.from_numpy(y)])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_want), atol=1e-5)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_want), atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_adain_from_shard_stats_is_merge_then_modulate(n):
    """The plain apply step (``ops.norm.adain_from_shard_stats``) and K1's
    apply op on CPU tensors (``wut::adain_apply``), fed n shards' stacked
    local statistics at uneven counts (uneven rows of 23-row planes),
    equal ``adain_from_stats`` of ``merge_plane_stats`` bit for bit, and
    the merge is the whole planes' mean and unbiased variance within
    1e-6."""
    from weather_unet_tpu_torch.kernels import adain as k1
    from weather_unet_tpu_torch.ops.norm import (
        _mean_var_unbiased, adain_from_shard_stats, adain_from_stats,
        merge_plane_stats, plane_stats)

    rng = np.random.default_rng(10 + n)
    x = torch.from_numpy(rng.standard_normal((2, 5, 23, 6))
                         .astype(np.float32) * 2 + 0.5)
    y = torch.from_numpy(rng.standard_normal((2, 20)).astype(np.float32))
    rows = [23 // n + (k < 23 % n) for k in range(n)]
    assert len(set(rows)) == 2
    parts = torch.split(x, rows, dim=2)
    shards = torch.stack([plane_stats(p) for p in parts])
    counts = [r * 6 for r in rows]
    merged = merge_plane_stats(shards, counts)
    want = adain_from_stats(x, y, merged, 1e-5)
    assert torch.equal(adain_from_shard_stats(x, y, shards, counts, 1e-5),
                       want)
    assert torch.equal(k1.adain_apply_op(x, y, shards, counts, 1e-5), want)
    mean, var = _mean_var_unbiased(x, (2, 3))
    np.testing.assert_allclose(merged[..., 0].numpy(), mean.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(merged[..., 1].numpy(), var.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_window_upsample_values_and_gradients_are_jax(use_pallas):
    """The 2x align-corners upsample of 40 rows over shards of 8, 16 and
    16, each from its slab with one halo row each side, plain and through
    K2's row-window op (``wut::upsample2x_rows``, its CPU form): the
    joined rows within 2e-6 of JAX's upsample of the whole image, the
    gradient (the halo rows' sent back to their owners) within 1e-5 of
    ``jax.vjp``'s."""
    group = three_shards(40)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, 9, 5)).astype(np.float32)
    g = rng.standard_normal((2, 80, 18, 5)).astype(np.float32)
    want, vjp = jax.vjp(jax_upsample, jnp.asarray(x))
    (gx_want,) = vjp(jnp.asarray(g))
    out, gx, _ = run_rows(group, nchw(x), nchw(g),
                          lambda xi: group.upsample(xi, use_pallas), [])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(gx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_want), atol=1e-5)


def test_window_staging_stays_in_the_halo():
    """At every decoder upsample input of 224² at degree 4 (48/64/48/64
    rows), 256² at degree 2 and 48² at degree 2, K2's row-window staging
    (``staged_rows`` with the window) stays inside the slab: no row above
    on the top shard, none below on the bottom one, at most one halo row
    either side elsewhere; the plan stages at most the slab and is the
    plan of its slab's shape; the whole-image plans are unchanged."""
    from weather_unet_tpu_torch.kernels.upsample import (
        plan_upsample, staged_rows)

    for size, n in ((224, 4), (256, 2), (48, 2)):
        cut = row_cut(size, n)
        for f in (8, 4, 2):
            total = size // f
            for k, (start, rows) in enumerate(cut):
                h, s = rows // f, start // f
                win = staged_rows(h, 8, (total, s))
                lo = min(a for a, _ in win)
                hi = max(z for _, z in win)
                assert lo >= (1 if k == 0 else 0)
                assert hi <= (h if k == n - 1 else h + 1)
                for dtype in (torch.float32, torch.bfloat16):
                    pl = plan_upsample(16, 128, h, total, dtype,
                                       window=(total, s))
                    assert pl["staged"] <= pl["pb"] * (h + 2)
                    assert pl["rows"] * pl["strips"] >= 2 * h
    assert plan_upsample(16, 512, 28, 28, torch.bfloat16)["name"] == (
        plan_upsample(16, 512, 28, 28, torch.bfloat16, window=None)["name"])
    assert staged_rows(28, 8) == staged_rows(28, 8, None)


def test_dropout_masks_are_the_unsharded_rows(cunet_vars):
    """A train-mode forward at rate 0.3 over two shards: each shard draws
    the whole mask from the same generator and keeps its rows, so the
    output equals the unsharded forward's with that generator (atol 1e-5)
    and not with another seed."""
    _, _, port = cunet_vars
    net = copy.deepcopy(port)
    net.dropout_rate = 0.3
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 32, 32)).astype(
        np.float32))
    c = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32))
    with torch.no_grad():
        want = net(x, c, train=True,
                   generator=torch.Generator().manual_seed(9))
        other = net(x, c, train=True,
                    generator=torch.Generator().manual_seed(10))
    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * 2), 32)
    shards = [spatial.spatial_(copy.deepcopy(net), group, i)
              for i in range(2)]
    outs = group.shards.run(lambda i, dev: shards[i](
        shard_rows(x, group, i), c, train=True,
        generator=torch.Generator().manual_seed(9)))
    got = torch.cat(outs, dim=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert float((got - other).abs().max()) > 1e-2


def test_gan_step_on_two_ranks_is_jax_step(tmp_path):
    """Two gloo ranks, ``data=1, model=2`` (16 rows each), one combined
    GAN step at 32², B=2 from JAX's initial state: the ranks byte-equal;
    d_loss and g_loss within rtol 1e-4 of JAX's unsharded step, the leaf
    JAX's own test holds within atol 1e-5, every G parameter within the
    Adam sign-flip bound (max 3·lr, mean 1e-6), D's ``u`` within 1e-4."""
    jcfg = jax_gan.GanConfig(input_size=32, batch_size=2, dropout_rate=0.0,
                             lr=LR, num_epoch=1)
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    cfg = GanConfig(input_size=32, batch_size=2, dropout_rate=0.0, lr=LR,
                    num_epoch=1)
    _, _, state = build_gan_state(cfg, 0, "cpu")
    load_jax_state(state, jstate)
    init = tmp_path / "init.pt"
    with open(init, "wb") as f:
        f.write(ckpt.serialize(ckpt._to_host(ckpt.gan_tree(state, 0))))
    out = tmp_path / "ranks"
    recs = run_worker(tmp_path, out, [
        "--mode", "gan", "--spatial", "2", "--size", "32", "--batch", "2",
        "--steps", "1", "--init", str(init), "--dump_inputs",
        "--device", "cpu"])
    assert recs[0]["metrics"] == recs[1]["metrics"]
    assert rank_bytes(out, 0) == rank_bytes(out, 1)
    assert recs[0]["tp_sums"] == recs[1]["tp_sums"]
    ins = [torch.load(out / f"rank{r}_in1.pt", weights_only=True)
           for r in range(2)]
    x, r = (torch.cat([ins[0][k], ins[1][k]], dim=2).permute(0, 2, 3, 1)
            .numpy() for k in (0, 2))
    assert ins[0][0].shape[2] == ins[1][0].shape[2] == 16
    lab = jnp.zeros(2, jnp.int32)
    js2, jm = jax.jit(lambda s, a, b, k: jax_gan.make_gan_step(
        jgen, jdisc, jest, jcfg)(s, a, lab, b, lab, k, do_g=True))(
        jstate, jnp.asarray(x), jnp.asarray(r), jax.random.key(1))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(recs[0]["metrics"][0][k], float(jm[k]),
                                   rtol=1e-4)
    _, _, got = build_gan_state(cfg, 0, "cpu")
    ckpt.restore_checkpoint(str(out / "rank0.pt"), got)
    want_g, want_d = jax_sds(js2)
    sg = got.gen.module.state_dict()
    # the port's name of the leaf JAX's test holds (jax.tree.leaves' first)
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


def test_refusals():
    """``spatial_`` refuses a ``fuse_upconv`` model, a tensor-parallel
    split and a second marking; the GAN step refuses one marked network;
    a marked ResNet refuses train-mode BatchNorm; placement takes NHWC
    images only; K1's split launches and K2's row-window launch refuse CPU
    tensors."""
    from weather_unet_tpu_torch.kernels import adain as k1
    from weather_unet_tpu_torch.kernels import upsample as k2

    group = spatial.SpatialGroup(tp.ThreadShards(["cpu"] * 2), 32)
    with pytest.raises(ValueError, match="fuse_upconv serving"):
        spatial.spatial_(ConditionalUNet(5, fuse_upconv=True), group, 0)
    split = tp.shard_(ConditionalUNet(5), tp.ThreadShards(["cpu"] * 2),
                      index=0)
    with pytest.raises(ValueError, match="tensor-parallel"):
        spatial.spatial_(split, group, 0)
    gen, disc = ConditionalUNet(5), SNDisc(5)
    spatial.spatial_(gen, group, 0)
    with pytest.raises(ValueError, match="split already"):
        spatial.spatial_(gen, group, 0)
    cfg = GanConfig(input_size=32, batch_size=2)
    with pytest.raises(ValueError, match="both networks"):
        make_gan_step(gen, disc, lambda x: x.mean(dim=(2, 3)), cfg)
    spatial.spatial_(disc, group, 0)
    est = spatial.spatial_(ResNet((1, 1, 1, 1), 5), group, 0)
    with pytest.raises(ValueError, match="train-mode BatchNorm"):
        est(torch.zeros(1, 3, 16, 32))
    plan = make_mesh(["cpu"] * 2, model=2)
    with pytest.raises(ValueError, match="NHWC"):
        put_host_local(plan.spatial(input_size=32), np.zeros((2, 32)))
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k1.adain_stats_kernel(x)
    with pytest.raises(ValueError, match="CUDA"):
        k1.adain_apply_kernel(x, torch.zeros(1, 8), torch.zeros(2, 1, 2, 2),
                              [32, 32], 1e-5)
    with pytest.raises(ValueError, match="1 to 16 shards"):
        k1.adain_apply_kernel(x, torch.zeros(1, 8),
                              torch.zeros(17, 1, 2, 2), [4] * 17, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        k2.upsample_rows_kernel(torch.zeros(1, 2, 10, 8), 16, 0)
