"""Split float32 ("3xTF32"), the arithmetic of K4's and K3's float32
tensor-core forms, and the Python around them, on the CPU: the TF32 split
(``kernels/bottleneck.py::split_tf32``), the claim that three TF32 products
meet float32's bar where one does not, the float32 tile plans, the split
weight packing, the rule that sends float32 to the tensor cores, and the
plain version on split weights against the JAX package's Pallas kernel in
interpret mode.  The kernels themselves run in tests/test_torch_gpu.py.

Tolerances: the bar of float32 on the card, 1e-5 * max(1, max|y|); 2^-22
relative for hi + lo against its float32 input; 1e-5 (times max|want| where
that exceeds 1) against JAX, as tests/test_torch_kernel_plans.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.kernels import bottleneck_pallas as jax_k4
from weather_unet_tpu_torch.kernels import bottleneck as k4
from weather_unet_tpu_torch.kernels import upconv as k3

F32_BAR = 1e-5
# identity blocks (C, H, W) of ResNet-101 at a 224x224 input: K4's sites
K4_SITES = ((256, 56, 56), (512, 28, 28), (1024, 14, 14), (2048, 7, 7))
# K3's decoder sites (C, O) of the cUNet
K3_SITES = ((512, 256), (256, 128), (128, 64))


def tf32_reference(v: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 11 significant bits, in
    float64 (independent of the bit operations under test): finite normal
    float32 values only."""
    v = v.astype(np.float64)
    e = np.floor(np.log2(np.abs(v)))
    ulp = np.exp2(e - 10)
    q = np.abs(v) / ulp
    return (np.sign(v) * np.floor(q + 0.5) * ulp).astype(np.float32)


def test_split_tf32_rounds_to_ten_bits_ties_away(rng):
    v = (rng.standard_normal(20000) * np.exp2(rng.integers(-60, 60, 20000))
         ).astype(np.float32)
    hi, lo = k4.split_tf32(torch.from_numpy(v))
    for t in (hi, lo):               # at most 10 explicit mantissa bits
        assert not bool((t.view(torch.int32) & 0x1FFF).any())
    np.testing.assert_array_equal(hi.numpy(), tf32_reference(v))
    # hi + lo gives the float32 input back to 2^-22 relative
    rel = np.abs(hi.double().numpy() + lo.double().numpy()
                 - v.astype(np.float64)) / np.abs(v.astype(np.float64))
    assert float(rel.max()) <= 2.0 ** -22
    # ties (the 13 dropped bits exactly 0x1000) round away from zero, both
    # signs; one bit less rounds down, one bit more up
    base = np.array([0x3F800000, 0x40490000, 0x3E2AA000], dtype=np.int32)
    for sign in (0, np.int32(-0x80000000)):
        for low, up in ((0x1000, True), (0x0FFF, False), (0x1001, True)):
            bits = (base | low) | sign
            got = k4.tf32_round(torch.from_numpy(bits).view(torch.float32))
            want = (base + (0x2000 if up else 0)) | sign
            np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                          want)


def test_split_tf32_zero_subnormal_inf_nan():
    f = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                      1e-40, -3e-42, 2.0 ** -149], dtype=torch.float32)
    hi, lo = k4.split_tf32(f)
    bits = f.view(torch.int32)
    # zeros keep their sign, infinities and NaN pass through
    assert torch.equal(hi.view(torch.int32)[:4], bits[:4])
    assert bool(torch.isnan(hi[4]))
    assert torch.equal(lo[:5], torch.zeros(5))
    # subnormals round on their bits as any other value: to multiples of
    # TF32's smallest step, 2^-136, so hi + lo keeps them to half of it
    assert not bool((hi.view(torch.int32)[5:] & 0x1FFF).any())
    err = (hi[5:].double() + lo[5:].double() - f[5:].double()).abs()
    assert float(err.max()) <= 2.0 ** -137
    assert float(hi[5]) > 0.0
    assert hi[6].item() == 0.0 and math.copysign(1, hi[6].item()) < 0
    assert float(hi[7]) == 0.0 == float(lo[7])   # below half a step


def dot_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A plain emulation of the float32 forms' products: a (M, K) and b
    (K, N) split into TF32 hi and lo; each step of 8 values sums its three
    products lo.hi + hi.lo + hi.hi into a fresh accumulator (exact partial
    products, summed in float64 and rounded to float32, as one step of the
    tensor cores), then a rounded float32 add into the running sum."""
    ah, al = (t.double().numpy() for t in k4.split_tf32(torch.from_numpy(a)))
    bh, bl = (t.double().numpy() for t in k4.split_tf32(torch.from_numpy(b)))
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        s = slice(k0, k0 + 8)
        step = al[:, s] @ bh[s] + ah[:, s] @ bl[s] + ah[:, s] @ bh[s]
        acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def dot_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One TF32 product: hi.hi, summed exactly."""
    ah = k4.split_tf32(torch.from_numpy(a))[0].double().numpy()
    bh = k4.split_tf32(torch.from_numpy(b))[0].double().numpy()
    return (ah @ bh).astype(np.float32)


@pytest.mark.parametrize("k", [64, 256, 512, 1024, 2048,      # the 1x1s
                               9 * 64, 9 * 128, 9 * 256,      # the 3x3s,
                               9 * 512])                      # and K3's
def test_three_tf32_products_meet_the_float32_bar(rng, k):
    # a ReLU'd activation against signed weights of the scale a layer
    # keeps its outputs O(1) with, and signed activations (K3's patch)
    a_relu = np.maximum(rng.standard_normal((32, k)), 0).astype(np.float32)
    a_signed = rng.standard_normal((32, k)).astype(np.float32)
    b = (rng.standard_normal((k, 32)) / math.sqrt(k)).astype(np.float32)
    for a in (a_relu, a_signed):
        y = a.astype(np.float64) @ b.astype(np.float64)
        bar = F32_BAR * max(1.0, float(np.abs(y).max()))
        assert float(np.abs(dot_3xtf32(a, b) - y).max()) <= bar / 4
        # the float32 product itself, summed in float32, for scale
        y32 = np.zeros_like(y, dtype=np.float32)
        for k0 in range(0, k, 8):
            y32 = (y32 + (a[:, k0:k0 + 8].astype(np.float64)
                          @ b[k0:k0 + 8].astype(np.float64)).astype(
                np.float32)).astype(np.float32)
        assert float(np.abs(y32 - y).max()) <= bar / 4
        # one TF32 product (11 significant bits) misses the bar
        assert float(np.abs(dot_tf32(a, b) - y).max()) > bar


@pytest.mark.parametrize("batch", [8, 16])
def test_float32_plans_fit_and_bfloat16_plans_unchanged(batch):
    for c, h, w in K4_SITES:
        p = c // 4
        plans = k4.bottleneck_plans(batch, c, p, h, w, esize=4)
        assert plans and k4.plan_bottleneck(batch, c, p, h, w,
                                            esize=4) == plans[0]
        assert len({pl["name"] for pl in plans}) == len(plans)
        for pl in plans:
            th, cs, kc = pl["th"], pl["cs"], pl["kc"]
            assert pl["esize"] == 4 and kc == 16 and pl["mi"] == 4
            nh, nt = (th + 2) * (w + 2), th * w
            assert cs in (1, 2, 4) and (cs == 1 or p % (32 * cs) == 0)
            assert 1 <= th <= h and -(-h // th) * th >= h and nt <= 256
            assert pl["m_halo"] % 16 == 0 and 0 <= pl["m_halo"] - nh < 16
            assert pl["m_tile"] % 16 == 0 and 0 <= pl["m_tile"] - nt < 16
            # a staged channel: 4 floats a 16-byte piece, 128 pieces at most
            assert pl["rs"] % 4 == 0 and pl["rs"] >= (th + 2) * w + 3
            assert pl["rs"] // 4 <= 128
            # regions in bytes: t1 and t2 in float32 (rows P + 4), the
            # repacked x (rows kc + 4), the ring with hi and lo parts
            nb3, nbmax = 32 * pl["wgn3"], 32 * max(pl["wgn12"], pl["wgn3"])
            assert pl["off_b"] >= max(pl["m_halo"] * (p + 4) * 4,
                                      nb3 * nt * 4)
            assert pl["off_w"] - pl["off_b"] >= max(
                pl["m_tile"] * (p + 4) * 4,
                2 * pl["m_halo"] * (kc + 4) * 4
                + pl["stages"] * kc * pl["rs"] * 4)
            assert pl["off_t"] - pl["off_w"] == (
                pl["stages"] * 2 * nbmax * (kc + 4) * 4)
            assert pl["smem"] == pl["off_t"] + 4 * pl["m_halo"]
            assert pl["smem"] <= k4.SMEM_LIMIT == 232_448
        assert k4.takes_tensor_cores(torch.float32, c, p, h, w)
    # bfloat16 plans as they were before the float32 forms (chosen plan,
    # bytes, count), esize=2 the default
    want = {16: ("4x56", "4x28k64", "2x14k64", "7x7/4k64"),
            8: ("4x56", "2x28k64", "2x14/2k64", "7x7/4k64")}[batch]
    for (c, h, w), name in zip(K4_SITES, want):
        pl = k4.plan_bottleneck(batch, c, c // 4, h, w)
        assert pl == k4.plan_bottleneck(batch, c, c // 4, h, w, esize=2)
        assert pl["name"] == name and pl["esize"] == 2
    assert [len(k4.bottleneck_plans(batch, c, c // 4, h, w))
            for c, h, w in K4_SITES] == [10, 24, 28, 22]
    assert k4.plan_bottleneck(16, 256, 64, 56, 56)["smem"] == 223_616


def test_upconv_float32_plan_at_every_site():
    for c, o in K3_SITES + ((16, 4), (32, 72)):
        pl = k3.plan_upconv(c, o, esize=4)
        # float32 takes the narrow tile; the wide one can be forced
        assert pl["name"] == "16x16x64" and pl["kc"] == 8
        wide = k3.plan_upconv(c, o, esize=4, wide=True)
        assert wide["name"] == "8x16x128"
        for p in (pl, wide):
            npos, m = (p["th"] + 2) * (p["tw"] + 2), p["th"] * p["tw"]
            assert m == (8 // p["wgn"]) * 64 and p["nb"] == 32 * p["wgn"]
            assert p["rs"] % 4 == 0 and p["rs"] >= p["tw"] // 2 + 3 + 3
            assert p["off_patch"] >= p["off_mod"] + c * 8
            # two float32 patches of rows 8 + 4, two staged regions, a ring
            # of hi and lo; the output stage reuses what lies behind
            assert p["off_raw"] - p["off_patch"] == 2 * npos * 12 * 4
            assert p["off_w"] - p["off_raw"] == 2 * 8 * p["lh"] * p["rs"] * 4
            assert p["smem"] >= p["off_w"] + 3 * 3 * p["nb"] * 12 * 4 * 2
            assert p["smem"] >= p["off_patch"] + p["nb"] * (m + 4) * 4
            assert p["smem"] <= k3.SMEM_LIMIT
            assert all(p[k] % 16 == 0 for k in
                       ("off_mod", "off_patch", "off_raw", "off_w"))
        # bfloat16 keeps its tile by O
        assert k3.plan_upconv(c, o)["nb"] == (128 if o > 64 else 64)
        assert k3.takes_tensor_cores(torch.float32, c) == (c % 16 == 0)


def test_split_packing_gives_back_the_fold(rng):
    c, p = 64, 16
    w1 = torch.from_numpy(rng.standard_normal((c, p)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((9, p, p)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((p, c)).astype(np.float32))
    b1, b2, b3 = torch.ones(p), torch.zeros(p), torch.ones(c)
    packed = k4.pack_bottleneck(w1, b1, w2, b2, w3, b3, torch.float32,
                                split=True)
    assert packed.split
    assert [tuple(t.shape) for t in packed] == [
        (2, p, c), (p,), (2, 9, p, p), (p,), (2, c, p), (c,)]
    plain = k4.pack_bottleneck(w1, b1, w2, b2, w3, b3, torch.float32)
    for got, perm in ((packed.w1, plain.w1), (packed.w2, plain.w2),
                      (packed.w3, plain.w3)):
        assert got.is_contiguous()
        assert torch.equal(got[0], k4.tf32_round(perm))
        assert not bool((got.view(torch.int32) & 0x1FFF).any())
        rel = ((got[0].double() + got[1].double() - perm.double()).abs()
               / perm.double().abs())
        assert float(rel.max()) <= 2.0 ** -22
    # unpacked: hi + lo in the fold's layout
    for got, want in zip(k4.unpack_bottleneck(packed), (w1, b1, w2, b2, w3,
                                                        b3)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2.0 ** -22 * float(
            want.abs().max())
    with pytest.raises(ValueError, match="split weights are float32"):
        k4.pack_bottleneck(w1, b1, w2, b2, w3, b3, torch.bfloat16, True)
    # K3: (2, 9, O, C), the permutation's hi and lo
    w = torch.from_numpy(rng.standard_normal((5, 16, 3, 3)).astype(
        np.float32))
    pw = k3.pack_upconv_weight(w, split=True)
    assert pw.shape == (2, 9, 5, 16) and pw.is_contiguous()
    assert torch.equal(pw[0], k4.tf32_round(k3.pack_upconv_weight(w)))
    back = k3.unpack_upconv_weight(pw)
    assert float((back - w).abs().max()) <= 2.0 ** -22 * float(
        w.abs().max())
    assert torch.equal(k3.unpack_upconv_weight(k3.pack_upconv_weight(w)), w)
    with pytest.raises(ValueError, match="float32"):
        k3.pack_upconv_weight(w.bfloat16(), split=True)


def test_rule_and_refusals_of_the_float32_forms():
    f32, bf = torch.float32, torch.bfloat16
    for c, h, w in K4_SITES:
        assert k4.takes_tensor_cores(f32, c, c // 4, h, w)
    # P below F32_MIN_P, channel counts, and rows no tile fits
    assert k4.F32_MIN_P == 64
    assert not k4.takes_tensor_cores(f32, 64, 16, 5, 7)
    assert not k4.takes_tensor_cores(f32, 128, 32)
    assert k4.takes_tensor_cores(bf, 128, 32)
    assert not k4.takes_tensor_cores(f32, 264, 72)
    assert not k4.takes_tensor_cores(f32, 256, 64, 2, 300)
    assert not k4.takes_tensor_cores(torch.float16, 256, 64)
    assert k3.takes_tensor_cores(f32, 16) and not k3.takes_tensor_cores(f32, 24)
    x = torch.zeros(1, 256, 4, 4)
    wts = (torch.zeros(256, 64), torch.zeros(64), torch.zeros(9, 64, 64),
           torch.zeros(64), torch.zeros(64, 256), torch.zeros(256))
    # float32 x needs split weights; with them the CPU tensor is refused
    with pytest.raises(ValueError, match="split"):
        k4.bottleneck_tc_kernel(x, k4.pack_bottleneck(*wts, f32))
    with pytest.raises(ValueError, match="CUDA"):
        k4.bottleneck_tc_kernel(x, k4.pack_bottleneck(*wts, f32, True))
    with pytest.raises(ValueError, match="CUDA"):
        k3.upconv_kernel(x, torch.zeros(8, 256, 3, 3))


def test_plain_version_on_split_weights_matches_pallas_interpret(rng):
    # the float32 form's weights (hi + lo) through the CPU wrapper against
    # the JAX kernel on the unsplit weights: the split moves nothing beyond
    # the float32 bar
    c, p = 128, 64
    x = rng.standard_normal((2, 9, 11, c)).astype(np.float32)
    w1 = (rng.standard_normal((c, p)) / c ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((9, p, p)) / (9 * p) ** 0.5).astype(np.float32)
    w3 = (rng.standard_normal((p, c)) / p ** 0.5).astype(np.float32)
    b1 = rng.uniform(0.5, 1.5, p).astype(np.float32)
    b2, b3 = (rng.standard_normal(n).astype(np.float32) for n in (p, c))
    want = np.asarray(jax_k4.fused_bottleneck_eval(
        *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, w3, b3)),
        interpret=True))
    wts = [torch.from_numpy(a) for a in (w1, b1, w2, b2, w3, b3)]
    packed = k4.pack_bottleneck(*wts, torch.float32, split=True)
    before = (k4.launches, k4.tensor_core_launches,
              k4.f32_tensor_core_launches)
    got = k4.fused_bottleneck_eval(nchw(x), packed)
    assert (k4.launches, k4.tensor_core_launches,
            k4.f32_tensor_core_launches) == before
    assert torch.equal(got, k4.bottleneck_eval_reference(
        nchw(x), *k4.unpack_bottleneck(packed)))
    tol = F32_BAR * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(nhwc(got) - want).max()) <= tol
