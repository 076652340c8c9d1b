"""The Python around the tensor-core kernels of K4 and K3
(weather_unet_tpu_torch.kernels.bottleneck / upconv): the tile plans, the
weight packing and the rule that picks a kernel, all on the CPU; and the two
wrappers on CPU tensors against the JAX package's Pallas kernels run in
interpret mode.  The kernels themselves run in tests/test_torch_gpu.py.
Tolerances: 0 for a permutation, 1e-6 on folded weights, 1e-5 (times
max|want| where that exceeds 1) against the JAX functions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_resnet import jax_resnet_variables, port_resnet
from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, oihw, one_torch_thread)
from weather_unet_tpu.kernels import bottleneck_pallas as jax_k4
from weather_unet_tpu.kernels import upconv_pallas
from weather_unet_tpu_torch.kernels import bottleneck as k4
from weather_unet_tpu_torch.kernels import upconv as k3

# identity-block sites (C, H, W) of ResNet-50/101 at a 224x224 input, then odd
# shapes: ragged rows, P = 16, a wide and short image, one pixel
RESNET_SITES = ((256, 56, 56), (512, 28, 28), (1024, 14, 14), (2048, 7, 7))
ODD_SITES = ((64, 5, 7), (128, 23, 21), (64, 9, 30), (64, 3, 100), (64, 1, 1))


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_bottleneck_plans_cover_image_and_fit_shared_memory(batch):
    for c, h, w in RESNET_SITES + ODD_SITES:
        p = max(c // 4, 16)
        plans = k4.bottleneck_plans(batch, c, p, h, w)
        assert plans and k4.plan_bottleneck(batch, c, p, h, w) == plans[0]
        assert len({pl["name"] for pl in plans}) == len(plans)
        for pl in plans:
            th, cs, kc = pl["th"], pl["cs"], pl["kc"]
            assert kc in (32, 64)
            nh, nt = (th + 2) * (w + 2), th * w
            # a cluster's blocks split every product's columns evenly
            assert cs in (1, 2, 4)
            assert cs == 1 or (c % (32 * cs) == 0 and p % (32 * cs) == 0)
            assert 1 <= th <= h and -(-h // th) * th >= h and nt <= 256
            # M padded to the mma's 16 rows, never cut
            assert pl["m_halo"] % 16 == 0 and 0 <= pl["m_halo"] - nh < 16
            assert pl["m_tile"] % 16 == 0 and 0 <= pl["m_tile"] - nt < 16
            assert pl["stages"] in (3, 4)
            assert pl["rs"] % 8 == 0 and pl["rs"] >= (th + 2) * w + 7
            assert pl["rs"] // 8 <= 128                  # four pieces a lane
            for wgn, n in ((pl["wgn12"], p // cs), (pl["wgn3"], c // cs)):
                assert wgn in (1, 2, 4, 8)
                assert wgn == 1 or 32 * wgn <= -(-n // 32) * 32
            # the regions hold what the kernel puts there, in order
            nb3, nbmax = 32 * pl["wgn3"], 32 * max(pl["wgn12"], pl["wgn3"])
            assert pl["off_b"] >= max(pl["m_halo"] * (p + 8) * 2, nb3 * nt * 4)
            assert pl["off_w"] - pl["off_b"] >= max(
                pl["m_tile"] * (p + 8) * 2,
                2 * pl["m_halo"] * (kc + 8) * 2
                + pl["stages"] * kc * pl["rs"] * 2)
            assert pl["off_t"] - pl["off_w"] == (
                pl["stages"] * nbmax * (kc + 8) * 2)
            assert pl["smem"] == pl["off_t"] + 4 * pl["m_halo"]
            assert pl["smem"] <= k4.SMEM_LIMIT == 232_448
            assert all(pl[k] % 16 == 0 for k in ("off_b", "off_w", "off_t"))
    # a 7x7 image is one tile: no halo is computed twice
    assert k4.plan_bottleneck(batch, 2048, 512, 7, 7)["th"] == 7
    # P = 16 cannot be split over a cluster
    assert {pl["cs"] for pl in k4.bottleneck_plans(batch, 64, 16, 5, 7)} == {1}
    assert {pl["cs"] for pl in k4.bottleneck_plans(batch, 1024, 256, 14, 14)
            } == {1, 2, 4}
    # the targets of the larger sites: a few full rows
    assert k4.plan_bottleneck(16, 256, 64, 56, 56)["th"] >= 2
    assert k4.plan_bottleneck(16, 1024, 256, 14, 14)["th"] in (2, 4, 7)
    with pytest.raises(ValueError, match="no tile"):
        k4.plan_bottleneck(batch, 64, 16, 2, 300)        # a row over 256 px
    with pytest.raises(ValueError, match="no tile"):
        k4.plan_bottleneck(batch, 256, 64, 56, 56, smem_limit=48 * 1024)


def test_pack_bottleneck_is_a_permutation_of_the_jax_fold():
    _, variables = jax_resnet_variables()
    model = port_resnet(variables).eval()      # resnet_state_dict_from_jax
    want = jax_k4.fold_bottleneck(variables["params"]["layer1_1"],
                                  variables["batch_stats"]["layer1_1"])
    folded = k4.fold_bottleneck(model.layer1[1].state_dict())
    packed = k4.pack_bottleneck(*folded, torch.float32)
    assert [tuple(t.shape) for t in packed] == [
        (64, 256), (64,), (9, 64, 64), (64,), (256, 64), (256,)]
    assert all(t.is_contiguous() for t in packed)
    w1, b1, w2, b2, w3, b3 = (np.asarray(a) for a in want)
    for got, ref in ((packed.w1, w1.T), (packed.w2, w2.transpose(0, 2, 1)),
                     (packed.w3, w3.T), (packed.b1, b1), (packed.b2, b2),
                     (packed.b3, b3)):
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    # the plain inverse gives the folded weights back bit for bit, also after
    # the cast the kernel's weights get
    for a, b in zip(k4.unpack_bottleneck(packed), folded):
        assert torch.equal(a, b)
    bf = k4.pack_bottleneck(*folded)
    assert bf.w2.dtype == torch.bfloat16 and bf.b2.dtype == torch.float32
    for a, b in zip(k4.unpack_bottleneck(bf), folded):
        assert torch.equal(a, b.to(a.dtype))


def test_fused_bottleneck_eval_on_cpu_takes_packed_weights(rng):
    c, p = 64, 16
    x = rng.standard_normal((2, 14, 14, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, p)) / c ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((9, p, p)) / (9 * p) ** 0.5).astype(np.float32)
    w3 = (rng.standard_normal((p, c)) / p ** 0.5).astype(np.float32)
    b1 = rng.uniform(0.5, 1.5, p).astype(np.float32)
    b2, b3 = (rng.standard_normal(n).astype(np.float32) for n in (p, c))
    want = np.asarray(jax_k4.fused_bottleneck_eval(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, w3, b3)),
        interpret=True))
    wts = [torch.from_numpy(a) for a in (w1, b1, w2, b2, w3, b3)]
    before = (k4.launches, k4.tensor_core_launches)
    got = k4.fused_bottleneck_eval(nchw(x), *wts)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    packed = k4.pack_bottleneck(*wts, torch.float32)
    assert torch.equal(k4.fused_bottleneck_eval(nchw(x), packed), got)
    # bfloat16: packed and unpacked weights round at the same points
    xb = nchw(x).bfloat16()
    assert torch.equal(
        k4.fused_bottleneck_eval(xb, k4.pack_bottleneck(*wts)),
        k4.bottleneck_eval_reference(xb, *wts))
    assert (k4.launches, k4.tensor_core_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        k4.bottleneck_tc_kernel(xb, k4.pack_bottleneck(*wts))
    with pytest.raises(ValueError, match="bfloat16"):
        k4.bottleneck_tc_kernel(nchw(x), packed)
    with pytest.raises(ValueError, match="multiples of 16"):
        k4.bottleneck_tc_kernel(
            torch.zeros(1, 24, 2, 2, dtype=torch.bfloat16),
            k4.pack_bottleneck(torch.zeros(24, 8), torch.zeros(8),
                               torch.zeros(9, 8, 8), torch.zeros(8),
                               torch.zeros(8, 24), torch.zeros(24)))


def test_rule_that_picks_the_tensor_core_kernels():
    bf, f32 = torch.bfloat16, torch.float32
    assert k4.takes_tensor_cores(bf, 256, 64)
    assert k4.takes_tensor_cores(bf, 64, 16)          # the odd site's P = 16
    assert not k4.takes_tensor_cores(f32, 256, 64)    # 1e-5 bar: no TF32
    assert not k4.takes_tensor_cores(bf, 4, 4)
    assert not k4.takes_tensor_cores(bf, 256, 24)
    assert not k4.takes_tensor_cores(bf, 40, 16)
    # ... and a tile of the image has to fit shared memory
    assert k4.takes_tensor_cores(bf, 64, 16, 5, 7)
    assert k4.takes_tensor_cores(bf, 2048, 512, 7, 7)
    assert not k4.takes_tensor_cores(bf, 64, 16, 2, 300)   # a row over 256 px
    assert not k4.takes_tensor_cores(bf, 256, 64, 200, 200)
    assert k3.takes_tensor_cores(bf, 128) and k3.takes_tensor_cores(bf, 16)
    assert not k3.takes_tensor_cores(f32, 128)
    assert not k3.takes_tensor_cores(bf, 8)           # the odd site's C = 8
    assert not k3.takes_tensor_cores(bf, 24)


def test_upconv_plan_and_weight_packing(rng):
    for c, o in ((512, 256), (256, 128), (128, 64), (16, 4), (32, 72)):
        pl = k3.plan_upconv(c, o)
        npos, m = (pl["th"] + 2) * (pl["tw"] + 2), pl["th"] * pl["tw"]
        assert pl["wgn"] in (2, 4) and pl["nb"] == 32 * pl["wgn"]
        assert m == (8 // pl["wgn"]) * 64 and pl["tw"] % 2 == 0
        assert (pl["nb"] == 64) == (o <= 64)
        assert pl["lh"] >= pl["th"] // 2 + 3
        assert pl["rs"] % 8 == 0 and pl["rs"] >= pl["tw"] // 2 + 3 + 7
        # tables, modulation, two patches, two staged regions, the ring; the
        # float32 output stage reuses everything behind the modulation
        assert pl["off_mod"] >= -(-npos * 4 // 8) * 8 + npos * 8
        assert pl["off_patch"] >= pl["off_mod"] + c * 8
        assert pl["off_raw"] - pl["off_patch"] == 2 * npos * 24 * 2
        assert pl["off_w"] - pl["off_raw"] == 2 * 16 * pl["lh"] * pl["rs"] * 2
        assert pl["smem"] >= pl["off_w"] + 3 * 3 * pl["nb"] * 24 * 2
        assert pl["smem"] >= pl["off_patch"] + pl["nb"] * (m + 4) * 4
        assert pl["smem"] <= k3.SMEM_LIMIT // 2   # two blocks an SM
        assert all(pl[k] % 16 == 0 for k in
                   ("off_mod", "off_patch", "off_raw", "off_w"))
    with pytest.raises(ValueError, match="shared memory"):
        k3.plan_upconv(1 << 15, 64)
    w = torch.from_numpy(rng.standard_normal((5, 16, 3, 3)).astype(np.float32))
    packed = k3.pack_upconv_weight(w)
    assert packed.shape == (9, 5, 16) and packed.is_contiguous()
    assert torch.equal(packed[2 * 3 + 1, 4], w[4, :, 2, 1])
    assert torch.equal(k3.unpack_upconv_weight(packed), w)


def test_upconv_on_cpu_matches_pallas_interpret_at_a_tensor_core_shape(rng):
    # C = 16: on a CUDA bfloat16 tensor this shape takes the tensor-core
    # kernel; on the CPU the wrapper runs the plain chain, here against JAX
    b, h, w, c, o = 2, 6, 9, 16, 8
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, c, o))).astype(np.float32)
    cb = rng.standard_normal((b, 2 * h, 2 * w, o)).astype(np.float32)
    sc = rng.uniform(0.5, 1.5, (b, c)).astype(np.float32)
    sh = rng.standard_normal((b, c)).astype(np.float32)
    want = np.asarray(upconv_pallas.upconv_block_fused(
        *(jnp.asarray(a) for a in (x, k, cb, sc, sh)), True, True))
    before = (k3.launches, k3.tensor_core_launches)
    got = nhwc(k3.upsample2x_conv3x3(
        nchw(x), oihw(k), cb=nchw(cb), scale=torch.from_numpy(sc),
        shift=torch.from_numpy(sh), relu=True))
    assert (k3.launches, k3.tensor_core_launches) == before
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol
    with pytest.raises(ValueError, match="CUDA"):
        k3.upconv_kernel(nchw(x).bfloat16(), oihw(k).bfloat16())
