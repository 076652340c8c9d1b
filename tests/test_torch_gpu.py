"""The port's CUDA kernels on a GPU, against their plain PyTorch versions.

Every test here carries the ``cuda`` marker and skips (inside the fixture)
where there is no GPU.  The file imports neither JAX nor the JAX package,
so it also runs on a GPU host without them; tests/conftest.py imports JAX,
so there run it as

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Tolerances: float32 max abs error 1e-5 * max(1, max|plain|) with TF32 off
(summation order, and in the tensor-core forms split float32's ~2^-21 a
product); bfloat16 2^-6 * max(1, max|plain|) (the plain chain rounds to bf16
after every op, the kernels once; K4 and its plain version round at the
same points and differ by summation order).

K3 and K4 run their tensor-core kernels where the shape allows
(``takes_tensor_cores``), float32 as split float32 (three TF32 mmas a
product).  A K4 tile plan is forced by passing one of ``bottleneck_plans(
..., esize=)`` to ``bottleneck_tc_kernel(x, packed, plan)``, a K3 tile by
passing ``plan_upconv(..., esize=, wide=)`` to ``upconv_kernel``; a K1
or K2 plan by passing one of ``adain_plans(...)`` / ``upsample_plans(...)``
to ``adain_kernel(x, y_proj, eps, plan)`` / ``upsample_kernel(x, plan)``.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.kernels import (
    adain as k1, bottleneck as k4, upconv as k3, upsample as k2)
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.fixture(autouse=True, scope="module")
def no_thread_left():
    """``tests/torch_port_util.py::no_thread_left``, here because this file
    runs on the GPU host without the repository's conftest (a ``tests``
    package installed there shadows the repository's directory)."""
    before = set(threading.enumerate())
    yield
    deadline = time.monotonic() + 10.0
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"threads left running: {sorted(t.name for t in left)}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no "
                    "CPU mode")
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def assert_close(out, ref, dtype):
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[dtype] * max(1.0, float(ref.float().abs().max()))
    assert err <= tol, (err, tol)


def assert_stats_close(got, ref):
    """Plane statistics (B, C, 2) = (mean, M2), each channel at its own
    scale: one tolerance over both would be set by M2, the larger, and
    pass a wrong mean."""
    tol = TOL[torch.float32]
    mean_err = float((got[..., 0] - ref[..., 0]).abs().max())
    assert mean_err <= tol * max(1.0, float(ref[..., 0].abs().max())), (
        "mean", mean_err)
    m2_err = float(((got[..., 1] - ref[..., 1]).abs()
                    / ref[..., 1].abs().clamp_min(1e-30)).max())
    assert m2_err <= tol, ("M2", m2_err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(2, 8, 5, 7, generator=g, device=cuda).to(dtype)
    y = torch.randn(2, 32, generator=g, device=cuda).to(dtype)
    n1 = k1.launches
    assert_close(k1.adain_fused(x, y), k1.adain_fused_ref(x, y), dtype)
    assert k1.launches == n1 + 1
    w = (0.3 * torch.randn(4, 8, 3, 3, generator=g, device=cuda)).to(dtype)
    cb = torch.randn(2, 4, 10, 14, generator=g, device=cuda).to(dtype)
    sc = torch.rand(2, 8, generator=g, device=cuda) + 0.5
    sh = torch.randn(2, 8, generator=g, device=cuda)
    n3 = k3.launches
    for kw in ({}, dict(cb=cb), dict(scale=sc, shift=sh, relu=True),
               dict(cb=cb, scale=sc, shift=sh, relu=True)):
        assert_close(k3.upsample2x_conv3x3(x, w, **kw),
                     k3.upsample2x_conv3x3_ref(x, w, **kw), dtype)
    torch.cuda.synchronize()
    assert k3.launches == n3 + 4


def test_kernel_backwards_match_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)

    def leaf(*shape):
        return torch.randn(*shape, generator=g, device=cuda).requires_grad_()

    x, y = leaf(2, 16, 8, 8), leaf(2, 64)
    for fused, plain, args in (
            (k1.adain_fused, k1.adain_fused_ref, (x, y)),
            (lambda *a: k3.upconv_block_fused(*a, True),
             lambda *a: k3.upconv_block_ref(*a, True),
             (x, leaf(4, 16, 3, 3), leaf(2, 4, 16, 16),
              (torch.rand(2, 16, device=cuda) + 0.5).requires_grad_(),
              leaf(2, 16)))):
        g1 = torch.autograd.grad(torch.sin(fused(*args)).sum(), args)
        g2 = torch.autograd.grad(torch.sin(plain(*args)).sum(), args)
        for a, b in zip(g1, g2):
            assert float((a - b).abs().max()) <= 1e-4 * max(
                1.0, float(b.abs().max()))


def test_kernels_refuse_non_contiguous_input(cuda):
    x = torch.zeros(2, 4, 6, 6, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k1.adain_kernel(x, torch.zeros(2, 16, device=cuda), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k1.adain_kernel(x.contiguous(),
                        torch.zeros(16, 2, device=cuda).t(), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        k3.upconv_kernel(x, torch.zeros(3, 4, 3, 3, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        k2.upsample_kernel(x)
    w = bottleneck_weights(4, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k4.bottleneck_kernel(x, *w)
    xb = torch.zeros(2, 16, 6, 6, device=cuda,
                     dtype=torch.bfloat16).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k4.bottleneck_tc_kernel(xb, k4.pack_bottleneck(
            *bottleneck_weights(16, 16, torch.bfloat16, cuda)))
    with pytest.raises(ValueError, match="contiguous"):
        k3.upconv_kernel(xb, torch.zeros(3, 16, 3, 3, device=cuda,
                                         dtype=torch.bfloat16))


def test_upsample_matches_plain(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=cuda).manual_seed(2)
        n = k2.launches
        shapes = ((2, 8, 5, 7), (1, 3, 1, 6), (1, 3, 6, 1), (3, 16, 32, 32),
                  (1, 2, 17, 130))
        for shape in shapes:
            x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
            ref = k2.upsample2x_fused_ref(x)
            assert_close(k2.upsample2x_fused(x), ref, dtype)
            # strided and channels-last inputs are made contiguous by the wrapper
            assert_close(k2.upsample2x_fused(
                x.contiguous(memory_format=torch.channels_last)), ref, dtype)
            assert_close(k2.upsample2x_fused(x.transpose(2, 3)),
                         k2.upsample2x_fused_ref(x.transpose(2, 3)), dtype)
        torch.cuda.synchronize()
        assert k2.launches == n + 3 * len(shapes)
        x = torch.randn(2, 4, 6, 9, generator=g, device=cuda).requires_grad_()
        g1, = torch.autograd.grad(torch.sin(k2.upsample2x_fused(x)).sum(), x)
        g2, = torch.autograd.grad(torch.sin(k2.upsample2x_fused_ref(x)).sum(), x)
        assert float((g1 - g2).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_box_use_pallas_matches_plain(cuda, dtype):
    """UpsampleBox's use_pallas route (K2, one launch a call) against its
    plain route on the card, eval and train mode: outputs at K2's bars, the
    running statistics to 1e-5 in float32 (bfloat16: K2's bar)."""
    from weather_unet_tpu_torch.models import UpsampleBox

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 32, 16, 24, generator=g, device=cuda).to(dtype)
    for train in (False, True):
        plain = UpsampleBox(32).to(cuda)
        plain.bn.running_mean.normal_(0.0, 1.0, generator=g)
        plain.bn.running_var.uniform_(0.5, 2.0, generator=g)
        fused = UpsampleBox(32, use_pallas=True).to(cuda)
        fused.load_state_dict(plain.state_dict())
        n = k2.launches
        out = fused(x, train=train)
        torch.cuda.synchronize()
        assert k2.launches == n + 1
        assert_close(out, plain(x, train=train), dtype)
        for name in ("running_mean", "running_var"):
            ref = getattr(plain.bn, name)
            tol = (1e-5 if dtype == torch.float32
                   else TOL[dtype] * max(1.0, float(ref.abs().max())))
            assert float((getattr(fused.bn, name) - ref).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_every_plan(cuda, dtype):
    """K1 under every plan at a tiny plane, at the 32x32 site's small-plane
    path (one warp a plane, fewer samples), at a 128x128 plane held by 16
    warps, at a plane beyond the on-chip limit (re-read), and at a plane
    whose size is not a multiple of a 16-byte load; y_proj in float32 and
    in bfloat16, whatever x's dtype."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for b, c, h, w in ((2, 8, 5, 7), (2, 64, 32, 32), (1, 4, 128, 128),
                       (1, 3, 150, 150), (2, 3, 1, 1), (1, 2, 9, 9)):
        x = (3 * torch.randn(b, c, h, w, generator=g, device=cuda) + 1).to(
            dtype)
        y32 = torch.randn(b, 4 * c, generator=g, device=cuda)
        for y in (y32, y32.to(torch.bfloat16)):
            ref = k1.adain_fused_ref(x, y)
            plans = k1.adain_plans(b, c, h, w, dtype)
            assert plans[0] == k1.plan_adain(b, c, h, w, dtype)
            n = k1.launches
            for plan in plans:
                assert_close(k1.adain_kernel(x, y, 1e-5, plan), ref, dtype)
            assert_close(k1.adain_fused(x, y), ref, dtype)
            torch.cuda.synchronize()
            assert k1.launches == n + len(plans) + 1
    # a plane of one value: variance 0 (divided by max(n - 1, 1)), out = y_mean
    x = torch.full((1, 2, 1, 1), 5.0, device=cuda, dtype=dtype)
    y = torch.tensor([[1.0, 2.0, 3.0, 6.0, 0.0, 0.0, 4.0, 4.0]], device=cuda)
    assert k1.adain_fused(x, y).float().flatten().tolist() == [3.0, 2.0]


def table_upsample(x):
    """The kernel's arithmetic in float64: x blended with the tap weights of
    ops/resize.py.  F.interpolate computes its source coordinate in float32,
    which on rows of a few hundred values moves it more than 1e-5 from
    these weights."""
    from weather_unet_tpu_torch.ops.resize import _interp_matrix_np

    h, w = x.shape[2:]
    mh, mw = (torch.from_numpy(_interp_matrix_np(2 * n, n)).double().to(
        x.device) for n in (h, w))
    return torch.einsum("oh,bchw,pw->bcop", mh, x.double(), mw)


def test_upsample_every_plan(cuda):
    """K2 under every plan, against its own tables in float64: widths whose
    rows are 16-byte aligned and not, H = 1, W = 1, several planes a block,
    strips of rows, rows longer than a block's 256 threads, a misaligned
    input view (the staged run starts inside a 16-byte piece)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    shapes = ((2, 8, 5, 7), (1, 3, 1, 6), (1, 3, 6, 1), (1, 1, 1, 1),
              (3, 16, 32, 32), (1, 2, 17, 130), (2, 4, 64, 66),
              (1, 2, 100, 12), (1, 1, 9, 300))
    for dtype in (torch.float32, torch.bfloat16):
        for shape in shapes:
            x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
            ref = table_upsample(x)
            plans = k2.upsample_plans(*shape, dtype)
            assert plans[0] == k2.plan_upsample(*shape, dtype)
            n = k2.launches
            for plan in plans:
                assert_close(k2.upsample_kernel(x, plan), ref, dtype)
            torch.cuda.synchronize()
            assert k2.launches == n + len(plans)
        flat = torch.randn(1 + 2 * 4 * 16 * 16, generator=g,
                           device=cuda).to(dtype)
        x = flat[1:].view(2, 4, 16, 16)          # contiguous, 2-4 bytes off
        assert x.data_ptr() % 16
        for plan in k2.upsample_plans(2, 4, 16, 16, dtype):
            assert_close(k2.upsample_kernel(x, plan), table_upsample(x),
                         dtype)


def test_one_device_kernel_a_call(cuda):
    """torch.profiler sees exactly one device kernel, and no other device
    work, in one adain_fused and one upsample2x_fused call on contiguous
    CUDA inputs: the wrappers do no PyTorch arithmetic on the card."""
    x = torch.randn(2, 16, 32, 32, device=cuda, dtype=torch.bfloat16)
    y = torch.randn(2, 64, device=cuda, dtype=torch.bfloat16)
    calls = 5
    for fn in (lambda: k1.adain_fused(x, y), lambda: k2.upsample2x_fused(x)):
        fn()                                    # tap tables cached
        torch.cuda.synchronize()
        # a profile can lose records: one name, never more than one record
        # a call, and one profile of five with all of them
        counts = []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA]
            assert len(set(names)) <= 1 and len(names) <= calls, names
            counts.append(len(names))
            if len(names) == calls:
                break
        assert counts[-1] == calls, counts


def bottleneck_weights(c, p, dtype, device, seed=3):
    """Kernel weights of a C -> P -> C block with non-zero biases."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, std=1.0):
        return std * torch.randn(*shape, generator=g, device=device)

    return ((randn(c, p, std=c ** -0.5)).to(dtype),
            torch.rand(p, generator=g, device=device) + 0.5,
            (randn(9, p, p, std=(9 * p) ** -0.5)).to(dtype), randn(p),
            (randn(p, c, std=p ** -0.5)).to(dtype), randn(c))


def test_bottleneck_matches_plain(cuda):
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=cuda).manual_seed(4)
        n = k4.launches
        # shapes that make the launcher pick each of its tiles (8x8, 4x8, 4x4,
        # 2x4 on a 132-SM card) with ragged edges, and the smallest channels
        shapes = ((4, 128, 48, 47), (2, 128, 48, 45), (2, 128, 30, 35),
                  (2, 128, 23, 21), (2, 64, 5, 7), (1, 4, 1, 1), (3, 2048, 7, 7))
        for b, c, h, w in shapes:
            x = torch.randn(b, c, h, w, generator=g, device=cuda).to(dtype)
            wts = bottleneck_weights(c, max(c // 4, 4), dtype, cuda)
            ref = k4.bottleneck_eval_reference(x, *wts)
            assert_close(k4.fused_bottleneck_eval(x, *wts), ref, dtype)
        torch.cuda.synchronize()
        assert k4.launches == n + len(shapes)
        # the 3x3 pads t1 with 0, not relu(b1): x = 0, w1 = 0, w2 = 1 count the
        # in-image neighbours of each pixel
        p = 4
        z = torch.zeros(p, device=cuda)
        out = k4.fused_bottleneck_eval(
            torch.zeros(1, p, 5, 6, device=cuda, dtype=dtype),
            torch.zeros(p, p, device=cuda), torch.full((p,), 2.0, device=cuda),
            torch.ones(9, p, p, device=cuda), z, torch.eye(p, device=cuda), z)
        assert [float(out[0, 0, i, j]) for i, j in ((2, 3), (0, 3), (4, 5))] == [
            9 * p * 2.0, 6 * p * 2.0, 4 * p * 2.0]


def test_bottleneck_tensor_cores_under_every_plan(cuda):
    """K4's tensor-core forms, bfloat16 and float32 (split float32), under
    every tile plan that fits: ragged last tiles (H not a multiple of the
    tile's rows), rows whose staged segments are misaligned (W = 7, 21, 30),
    non-zero b1, and the zero halo.  The plans are forced where the rule
    would take the CUDA cores (float32 with P < 64); the wrapper follows the
    rule."""
    g = torch.Generator(device=cuda).manual_seed(7)
    shapes = ((2, 64, 5, 7), (3, 128, 23, 21), (2, 64, 9, 30), (1, 32, 4, 4),
              (2, 512, 15, 14), (2, 2048, 7, 7), (1, 64, 3, 100),
              (2, 256, 12, 10))
    for dt in (torch.bfloat16, torch.float32):
        f32, esize = dt == torch.float32, 4 if dt == torch.float32 else 2
        for b, c, h, w in shapes:
            p = max(c // 4, 16)
            x = torch.randn(b, c, h, w, generator=g, device=cuda).to(dt)
            wts = bottleneck_weights(c, p, dt, cuda)
            assert float(wts[1].abs().min()) > 0
            ref = k4.bottleneck_eval_reference(x, *wts)
            packed = k4.pack_bottleneck(*wts, dt, f32)
            plans = k4.bottleneck_plans(b, c, p, h, w, esize=esize)
            rule = k4.takes_tensor_cores(dt, c, p, h, w)
            assert plans and rule == (not f32 or p >= k4.F32_MIN_P)
            n, n_tc = k4.launches, k4.tensor_core_launches
            n_f32 = k4.f32_tensor_core_launches
            for plan in plans:
                assert_close(k4.bottleneck_tc_kernel(x, packed, plan), ref, dt)
            # the wrapper takes the rule's route, packed or not
            assert_close(k4.fused_bottleneck_eval(x, *wts), ref, dt)
            assert_close(k4.fused_bottleneck_eval(x, packed), ref, dt)
            torch.cuda.synchronize()
            want = len(plans) + 2 * rule
            assert k4.launches - n == len(plans) + 2
            assert k4.tensor_core_launches - n_tc == want
            assert k4.f32_tensor_core_launches - n_f32 == want * f32
        # the 3x3 pads t1 with 0, not relu(b1): x = 0, w1 = 0, w2 = 1 count
        # the in-image neighbours of each pixel, under every plan
        p = 16
        z = torch.zeros(p, device=cuda)
        packed = k4.pack_bottleneck(
            torch.zeros(p, p, device=cuda), torch.full((p,), 2.0, device=cuda),
            torch.ones(9, p, p, device=cuda), z, torch.eye(p, device=cuda), z,
            dt, f32)
        x = torch.zeros(1, p, 5, 6, device=cuda, dtype=dt)
        for plan in k4.bottleneck_plans(1, p, p, 5, 6, esize=esize):
            out = k4.bottleneck_tc_kernel(x, packed, plan)
            assert [float(out[0, 0, i, j])
                    for i, j in ((2, 3), (0, 3), (4, 5))] == [
                9 * p * 2.0, 6 * p * 2.0, 4 * p * 2.0], plan["name"]
        # a shape no tile fits goes to the CUDA cores, by the rule
        x = torch.randn(1, 64, 2, 300, generator=g, device=cuda).to(dt)
        wts = bottleneck_weights(64, 16, dt, cuda)
        n_tc = k4.tensor_core_launches
        assert_close(k4.fused_bottleneck_eval(x, *wts),
                     k4.bottleneck_eval_reference(x, *wts), dt)
        assert k4.tensor_core_launches == n_tc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_every_option_ragged_and_wide(cuda, dtype):
    """K3 in every cb / modulation / relu combination at a ragged shape, at
    shapes with more output channels than one block's N tile (64 or 128), and
    at a width whose rows are not 16-byte aligned; bfloat16 runs the
    tensor-core kernel wherever C is a multiple of 16."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for b, c, h, w, o in ((2, 16, 5, 7, 4), (1, 32, 14, 14, 72),
                          (2, 48, 28, 28, 130), (2, 8, 5, 7, 4),
                          (1, 16, 9, 20, 64)):
        x = torch.randn(b, c, h, w, generator=g, device=cuda).to(dtype)
        wt = (torch.randn(o, c, 3, 3, generator=g, device=cuda)
              / (9 * c) ** 0.5).to(dtype)
        cb = torch.randn(b, o, 2 * h, 2 * w, generator=g, device=cuda).to(dtype)
        sc = torch.rand(b, c, generator=g, device=cuda) + 0.5
        sh = torch.randn(b, c, generator=g, device=cuda)
        n, n_tc = k3.launches, k3.tensor_core_launches
        for use_cb in (False, True):
            for use_mod in (False, True):
                for relu in (False, True):
                    kw = dict(cb=cb if use_cb else None,
                              scale=sc if use_mod else None,
                              shift=sh if use_mod else None, relu=relu)
                    assert_close(k3.upsample2x_conv3x3(x, wt, **kw),
                                 k3.upsample2x_conv3x3_ref(x, wt, **kw), dtype)
        torch.cuda.synchronize()
        assert k3.launches == n + 8
        assert k3.tensor_core_launches - n_tc == (
            8 if k3.takes_tensor_cores(dtype, c) else 0)
        # both tiles of the tensor-core form (float32 as split float32)
        if k3.takes_tensor_cores(dtype, c):
            esize = 4 if dtype == torch.float32 else 2
            ref = k3.upconv_block_ref(x, wt, cb, sc, sh, True)
            for wide in (False, True):
                plan = k3.plan_upconv(c, o, esize=esize, wide=wide)
                assert_close(k3.upconv_kernel(x, wt, cb, sc, sh, True, plan),
                             ref, dtype)
    # zero padding after modulation: a constant image with a shift has its
    # border pixels see fewer taps
    x = torch.zeros(1, 16, 4, 4, device=cuda, dtype=dtype)
    wt = torch.ones(1, 16, 3, 3, device=cuda, dtype=dtype)
    out = k3.upsample2x_conv3x3(x, wt, scale=torch.ones(1, 16, device=cuda),
                                shift=torch.ones(1, 16, device=cuda))
    assert [float(out[0, 0, i, j]) for i, j in ((3, 3), (0, 3), (7, 7))] == [
        9 * 16.0, 6 * 16.0, 4 * 16.0]


def test_fused_resnet_eval_on_gpu_matches_cpu_module(cuda):
    model = ResNet((2, 1, 2, 1), 5, generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 2.0, generator=g)
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.1, generator=g)
        for name, par in model.named_parameters():
            if "bn" in name or "downsample.1" in name:
                par.copy_(torch.rand(par.shape, generator=g) + 0.5
                          if name.endswith("weight")
                          else 0.1 * torch.randn(par.shape, generator=g))
    model.eval()
    x = torch.randn(3, 3, 64, 64, generator=g)
    with torch.no_grad():
        want = model(x)
    assert float(want.std()) > 1e-3
    n = k4.launches
    got = k4.fused_resnet_eval(model.to(cuda))(x.to(cuda))
    assert k4.launches == n + 2        # the identity blocks of layers 1 and 3
    assert float((got.cpu() - want).abs().max()) <= 2e-4 * max(
        1.0, float(want.abs().max()))


def test_serving_configurations_on_gpu_match_cpu(cuda):
    """Each configuration on the card, through the bucketed API (batch 3 ->
    4), against the plain model on the CPU; 3 launches per forward."""
    torch.manual_seed(0)
    sd = ConditionalUNet(5).state_dict()
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (3, 64, 64, 3)).astype(np.float32)
    c = np.eye(5, dtype=np.float32)[[0, 2, 4]]
    cpu_model = ConditionalUNet(5)
    cpu_model.load_state_dict(sd)
    want = WeatherTransfer(cpu_model, device="cpu").translate(x, c).numpy()
    for kw, counters in (({}, ()), ({"use_pallas": True}, (k1, k2)),
                         ({"fuse_upconv": True}, (k3,))):
        model = ConditionalUNet(5, **kw)
        model.load_state_dict(sd)
        wt = WeatherTransfer(model)
        before = [m.launches for m in (k1, k2, k3)]
        got = wt.translate(x, c).cpu().numpy()
        assert [m.launches for m in (k1, k2, k3)] == [
            n + 3 * (m in counters) for n, m in zip(before, (k1, k2, k3))]
        assert float(np.abs(got - want).mean()) <= 1e-5, kw


def gan_step_once(device, use_pallas, scale=1.0, aot_cache=None):
    """One combined GAN step (est mode, 32x32, batch 2, dropout 0) from a
    seeded state on ``device``, with a linear estimator head on mean-pooled
    pixels, its images multiplied by ``scale``; with ``aot_cache`` through
    the AOT tier (a CUDA graph, Adam capturable).  Returns (state, metrics,
    K1 launches, K2 launches)."""
    cfg = GanConfig(input_size=32, batch_size=2, dropout_rate=0.0)
    _, _, state = build_gan_state(cfg, 0, device, use_pallas=use_pallas)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)
                         ).to(device)
    images, rand = (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32))
                                     .astype(np.float32)).to(device)
                    for _ in range(2))
    z = torch.zeros(2, dtype=torch.long, device=device)
    step = make_gan_step(state.gen.module, state.disc.module,
                         lambda x: x.mean(dim=(2, 3)) @ w, cfg)
    if aot_cache is not None:
        from weather_unet_tpu_torch.core.optim import set_capturable
        from weather_unet_tpu_torch.train.loops import _tiered_steps

        for ts in (state.gen, state.disc):
            set_capturable(ts.optimizer, True)
        programs = step.programs
        (programs[True], programs[False]), _ = _tiered_steps(
            [programs[True], programs[False]], aot_cache)
    n1, n2 = k1.launches, k2.launches
    state, m = step(state, images * scale, z, rand, z,
                    torch.Generator(device=device).manual_seed(0), do_g=True)
    return state, m, k1.launches - n1, k2.launches - n2


def moments(state, net):
    """(first, square root of the second) Adam moments of one network,
    flattened in parameter order (with beta1 = 0, after one step the first
    is the gradient itself)."""
    ts = getattr(state, net)
    stepped = [p for p in ts.module.parameters() if p in ts.optimizer.state]
    return tuple(torch.cat([ts.optimizer.state[p][key].cpu().flatten()
                            for p in stepped]) ** power
                 for key, power in (("exp_avg", 1.0), ("exp_avg_sq", 0.5)))


def moment_errs(a, b):
    """Per network and moment, max |a - b| over the largest |b|."""
    return {(net, i): float((x - y).abs().max() / y.abs().max())
            for net in ("gen", "disc")
            for i, (x, y) in enumerate(zip(moments(a, net), moments(b, net)))}


def float32_floor(device, use_pallas, b):
    """How far the step's moments move when its images move by one or two
    float32 roundings (scale 1 +- 2^-23), against the unperturbed step b."""
    errs = [moment_errs(gan_step_once(device, use_pallas,
                                      1 + sign * 2.0 ** -23)[0], b)
            for sign in (1, -1)]
    return {k: max(e[k] for e in errs) for k in errs[0]}


def assert_gan_steps_agree(a, b, ma, mb, floor, lr=1e-4):
    """Losses within rel 1e-4; Adam's moments within 1e-4 of the network's
    largest element plus twice ``floor`` (float32_floor: the cUNet's
    gradient sums cancel, so any two float32 computations of the step split
    by about that much); updated parameters within the Adam sign-flip bound
    (fewer than 0.5% of the elements beyond 5e-5, none beyond 2.2 * lr: an
    update is about lr * sign(g), so only the moments see a gradient of the
    wrong size); u within 1e-4."""
    for k in mb:
        assert abs(float(ma[k]) - float(mb[k])) <= 1e-4 * abs(float(mb[k])), k
    for net in ("gen", "disc"):
        pa = dict(getattr(a, net).module.named_parameters())
        pb = dict(getattr(b, net).module.named_parameters())
        diff = torch.cat([(pa[k].detach().cpu() - pb[k].detach().cpu())
                          .abs().flatten() for k in pb])
        assert float((diff > 5e-5).float().mean()) < 5e-3, net
        assert float(diff.max()) <= 2.2 * lr + 1e-6, net
    for k, err in moment_errs(a, b).items():
        assert err <= 1e-4 + 2 * floor[k], (k, err, floor[k])
    ub = b.disc.module.state_dict()
    for k, v in a.disc.module.state_dict().items():
        if k.endswith("weight_u"):
            assert float((v.cpu() - ub[k].cpu()).abs().max()) <= 1e-4, k


def test_gan_step_use_pallas_matches_plain(cuda):
    """The step through K1 and K2 (6 launches each: 3 per G forward, 2 G
    forwards) against the plain step, float32 with TF32 off."""
    a, ma, n1, n2 = gan_step_once(cuda, use_pallas=True)
    b, mb, m1, m2 = gan_step_once(cuda, use_pallas=False)
    assert (n1, n2, m1, m2) == (6, 6, 0, 0)
    assert_gan_steps_agree(a, b, ma, mb, float32_floor(cuda, False, b))


def test_gan_step_on_gpu_matches_cpu(cuda):
    a, ma, n1, n2 = gan_step_once(cuda, use_pallas=True)
    b, mb, _, _ = gan_step_once("cpu", use_pallas=True)
    assert (n1, n2) == (6, 6)
    assert_gan_steps_agree(a, b, ma, mb, float32_floor("cpu", True, b))


def test_device_prefetch_delivers_the_batches(cuda):
    """Pinned copies on a side stream, depth 2, of the selected fields: the
    same values as the CPU pass-through; other fields stay on the host."""
    from weather_unet_tpu_torch.data.pipeline import device_prefetch

    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
                rng.standard_normal((4, 5)).astype(np.float32),
                np.asarray([f"p{i}" for i in range(4)], dtype=object))
               for _ in range(5)]
    host = list(device_prefetch(iter(batches), "cpu"))
    got = list(device_prefetch(iter(batches), cuda, depth=2,
                               device_fields=[0]))
    assert len(got) == len(host) == 5
    for g, h in zip(got, host):
        assert g[0].device.type == "cuda" and g[0].dtype == torch.uint8
        torch.testing.assert_close(g[0].cpu(), torch.from_numpy(h[0]),
                                   rtol=0, atol=0)
        assert g[1] is h[1] and g[2] is h[2]


def test_trainer_steps_launch_k1_k2_k4(cuda, tmp_path):
    """Two trainer steps in bf16 (GD_train_ratio 2: a D-only step, then a
    combined one) through load_step_estimator's K4 route over a
    depth-(2, 2, 2, 2) ResNet (4 identity blocks): K1 and K2 3 + 6, K4 2 x 4
    a step (the two stop-gradient forwards)."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    est = str(tmp_path / "est.pt")
    torch.save(ResNet((2, 2, 2, 2), 5, generator=torch.Generator()
                      .manual_seed(3)).state_dict(), est)
    cfg = GanConfig(input_size=32, batch_size=2, gd_train_ratio=2,
                    dtype=torch.bfloat16, num_epoch=1)
    tr = WeatherTransferTrainer(
        cfg, load_step_estimator(est, dtype=torch.bfloat16, device=cuda),
        save_dir=str(tmp_path / "cp"), log_dir=str(tmp_path / "runs"),
        device=cuda)
    rng = np.random.default_rng(2)
    data = [(rng.integers(0, 256, (32, 32, 3), np.uint8), True)
            for _ in range(4)]
    counts = {m: m.launches for m in (k1, k2, k4)}
    try:
        assert tr.train_epoch(BatchLoader(data, 2), BatchLoader(data, 2))
        torch.cuda.synchronize()
    finally:
        tr.writer.close()      # and TensorBoard's writer thread
    got = {m: m.launches - n for m, n in counts.items()}
    assert got == {k1: 9, k2: 9, k4: 16}
    assert (tr.state.global_step, tr.state.gen.step) == (2, 1)


def smooth_images(n, size, seed):
    """Seeded smooth-plus-noise uint8 NHWC images, photo-like."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = []
    for _ in range(n):
        base = rng.uniform(0, 255, 3) * (0.5 + 0.5 * np.sin(
            xx[..., None] / rng.uniform(8, 40)
            + yy[..., None] / rng.uniform(8, 40)))
        out.append(np.clip(base + rng.normal(0, 12, base.shape), 0, 255))
    return np.stack(out).astype(np.uint8)


def test_device_augment_matches_native_and_cpu(cuda):
    """The device augment on the card at 257x257 -> 224x224 with resized
    crop and all three jitters: against the native C++ augment given the
    same affine and factors, within one uint8 step + 1e-3 (the bar of
    tests/test_native_augment.py: the C++ path rounds to uint8); against the
    same call on the CPU with the same draws, within 1e-5 (float32)."""
    from weather_unet_tpu_torch import runtime
    from weather_unet_tpu_torch.data import transforms as tf

    rt = runtime.build()
    cfg = tf.AugmentConfig(out_size=224, resized_crop=True, brightness=0.5,
                           contrast=0.3, saturation=0.3)
    imgs = smooth_images(4, 257, 5)
    x = torch.from_numpy(imgs).to(cuda)
    u, fs = tf.draw_uniforms(torch.Generator(cuda).manual_seed(0), 4, cfg)
    mats = tf.affine_from_uniforms(u, 257, 257, cfg)
    dev = tf._color_jitter(tf._affine_sample(x, mats, 224), fs, cfg).cpu()
    for i in range(4):
        nat = rt.augment_u8(imgs[i], mats[i].cpu().numpy(),
                            fs[i].cpu().numpy(), 224)
        err = float((torch.from_numpy(nat).float() / 255.0 - dev[i]).abs()
                    .max())
        assert err <= 1 / 255 + 1e-3, (i, err)
    card = tf.augment_from_uniforms(x, u, fs, cfg).cpu()
    cpu = tf.augment_from_uniforms(x.cpu(), u.cpu(), fs.cpu(), cfg)
    assert float((card - cpu).abs().max()) <= 1e-5


def test_http_server_answers_through_k1_k2(cuda, tmp_path):
    """The HTTP server on the card (use_pallas by default) answers one
    request; the device forward launches K1 and K2 three times each, and
    the answer is within 1 uint8 step of the same model on the CPU."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from weather_unet_tpu_torch.cli import serve

    torch.manual_seed(0)
    path = str(tmp_path / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict()}, path)
    server = serve.build_server(serve.build_parser().parse_args([
        "--cp_path", path, "--host", "127.0.0.1", "--port", "0",
        "--input_size", "64", "--max_batch", "2", "--no-warmup"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    rng = np.random.default_rng(0)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        buf, "PNG")
    try:
        assert server.transfer.device.type == "cuda"
        before = (k1.launches, k2.launches)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/translate?class=2",
            data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            got = np.asarray(Image.open(io.BytesIO(r.read())), np.int16)
        assert (k1.launches - before[0], k2.launches - before[1]) == (3, 3)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    x = serve._decode_resize(buf.getvalue(), 64)[None]
    c = np.eye(5, dtype=np.float32)[[2]]
    cpu = WeatherTransfer.load(path, device="cpu").translate_u8(x, c)
    enc = io.BytesIO()
    Image.fromarray(cpu.numpy()[0]).save(enc, "JPEG", quality=95)
    want = np.asarray(Image.open(enc), np.int16)
    assert got.shape == (64, 64, 3)
    # the JPEG encode can move a pixel that a 1-step difference flipped
    assert float(np.abs(got - want).mean()) <= 1.0


def test_inception_on_gpu_matches_cpu(cuda):
    """The FID Inception-v3 (seeded random weights, BatchNorm calibrated on
    the CPU) on the card against the CPU: pool3 features of 4 images at
    128x128 (resized to 299 inside) within a relative L2 error of 1e-4 with
    TF32 off (float32 order, amplified by the calibrated network), the
    1008-way logits likewise."""
    from weather_unet_tpu_torch.models.inception_fid import (
        InceptionV3FID, calibrate_batchnorm)

    gen = torch.Generator().manual_seed(0)
    model = calibrate_batchnorm(
        InceptionV3FID(with_logits=True, generator=gen),
        torch.rand(4, 3, 128, 128, generator=gen))
    pool3 = InceptionV3FID().eval()
    pool3.load_state_dict({k: v for k, v in model.state_dict().items()
                           if not k.startswith("fc.")})
    x = torch.rand(4, 3, 128, 128, generator=gen)
    for net in (pool3, model):
        with torch.no_grad():
            want = net(x)
            got = net.to(cuda)(x.to(cuda)).cpu()
        rel = float((got - want).norm() / want.norm())
        assert rel <= 1e-4, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exported_artifact_on_gpu(cuda, dtype, tmp_path):
    """The use_pallas cUNet exported on the card (symbolic batch), saved and
    loaded as ``ExportedTransfer``, at batches 1, 3 and 16 against the live
    model through ``WeatherTransfer``: within 1e-5 MAE of the live model in
    its dtype (the export must not change the function), and in bfloat16
    no further from the live float32 model than the live bfloat16 model is
    (+1e-5); translate_u8 within 1 step; every forward of the program
    launches K1 and K2 3 times each, seen by their counters and by their
    kernels' names under torch.profiler."""
    from weather_unet_tpu_torch.core.export import (
        ExportedTransfer, export_transfer, save_artifact)

    sd = ConditionalUNet(5, generator=torch.Generator().manual_seed(1)
                         ).state_dict()
    live = {}
    for dt in {torch.float32, dtype}:
        model = ConditionalUNet(5, dtype=dt, use_pallas=True)
        model.load_state_dict(sd)
        live[dt] = WeatherTransfer(model)
    save_artifact(str(tmp_path), export_transfer(live[dtype].model, size=64))
    art = ExportedTransfer(str(tmp_path))
    rng = np.random.default_rng(2)
    for b in (1, 3, 16):
        x = rng.uniform(-1, 1, (b, 64, 64, 3)).astype(np.float32)
        c = np.eye(5, dtype=np.float32)[rng.integers(0, 5, b)]
        n1, n2 = k1.launches, k2.launches
        got = art.translate(x, c).float()
        assert (k1.launches - n1, k2.launches - n2) == (3, 3)
        same = live[dtype].translate(x, c).float()
        f32 = live[torch.float32].translate(x, c).float()
        assert float((got - same).abs().mean()) <= 1e-5, b
        assert float((got - f32).abs().mean()) <= float(
            (same - f32).abs().mean()) + 1e-5, b
        u8 = rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)
        diff = (art.translate_u8(u8, c).int()
                - live[dtype].translate_u8(u8, c).int()).abs()
        assert int(diff.max()) <= 1, b
    for _ in range(5):      # a profile can lose a short kernel's record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            art.translate(x, c)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        seen = (sum("adain" in n for n in names),
                sum("upsample2x" in n for n in names))
        if seen == (3, 3):
            break
    assert seen == (3, 3), names


def test_aot_serving_bucket_graphed_matches_eager(cuda, tmp_path):
    """A bucket of the tiered ``WeatherTransfer`` (batch 3 -> 4, 64x64,
    float32 with TF32 off) runs as a CUDA graph: within 1 uint8 step and
    MAE 1e-5 of the eager forward; a replay runs no Python wrapper, so the
    launch counters stay still (they count eager launches only)."""
    torch.manual_seed(0)
    model = ConditionalUNet(5, use_pallas=True)
    eager = WeatherTransfer(model)
    tier = WeatherTransfer(model, aot_cache=str(tmp_path))
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (3, 64, 64, 3), np.uint8)
    c = np.eye(5, dtype=np.float32)[[0, 2, 4]]
    got = tier.translate_u8(u8, c)
    assert int((got.int() - eager.translate_u8(u8, c).int()).abs().max()
               ) <= 1
    x = WeatherTransfer.preprocess(u8)
    mae = (tier.translate(x, c) - eager.translate(x, c)).abs().mean()
    assert float(mae) <= 1e-5
    assert tier.aot.stats["captures"] == 2 and tier.aot.stats["programs"] == 2
    before = (k1.launches, k2.launches)
    again = tier.translate_u8(u8, c)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == before and torch.equal(again, got)


def test_aot_two_entry_points_capture_from_two_threads(cuda, tmp_path):
    """``translate`` and ``translate_u8`` of one tiered ``WeatherTransfer``
    share an ``AotCache`` and its side stream; two threads reaching new
    buckets through them at once capture one at a time, and every graph
    computes what the eager forward does (float32, TF32 off: MAE 1e-5, 1
    uint8 step)."""
    torch.manual_seed(0)
    model = ConditionalUNet(5, use_pallas=True)
    eager = WeatherTransfer(model)
    tier = WeatherTransfer(model, aot_cache=str(tmp_path))
    rng = np.random.default_rng(1)
    u8 = {b: rng.integers(0, 256, (b, 64, 64, 3), np.uint8) for b in (1, 2)}
    c = {b: np.eye(5, dtype=np.float32)[:b] for b in (1, 2)}
    got, errors = {}, []

    def run(name, fn, inputs):
        try:
            for b in (1, 2, 1, 2):
                got[name, b] = fn(inputs[b], c[b])
        except Exception as e:      # noqa: BLE001  (re-raised below)
            errors.append(e)

    x = {b: WeatherTransfer.preprocess(u8[b]) for b in (1, 2)}
    threads = [threading.Thread(target=run, args=a) for a in (
        ("u8", tier.translate_u8, u8), ("f32", tier.translate, x))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert tier.aot.stats["captures"] == 4
    for b in (1, 2):
        assert int((got["u8", b].int() - eager.translate_u8(
            u8[b], c[b]).int()).abs().max()) <= 1
        assert float((got["f32", b] - eager.translate(x[b], c[b])).abs()
                     .mean()) <= 1e-5


def test_aot_gan_step_graphed_matches_eager(cuda, tmp_path):
    """The combined step captured as a CUDA graph (float32, TF32 off,
    dropout 0, use_pallas) against the eager step from the same seed, at
    the float32 GAN bars (Adam's capturable update sums in another order)."""
    a, ma, _, _ = gan_step_once(cuda, use_pallas=True,
                                aot_cache=str(tmp_path))
    b, mb, _, _ = gan_step_once(cuda, use_pallas=True)
    assert a.global_step == b.global_step == 1
    assert_gan_steps_agree(a, b, ma, mb, float32_floor(cuda, True, b))


def test_aot_trainer_d_only_then_combined_then_d_only(cuda, tmp_path):
    """GD_train_ratio 2 through the tiered trainer on a fresh run: step 1
    captures the D-only program while G's Adam has no state yet, step 2's
    D+G capture creates that state, and step 3 replays the D-only graph,
    which reads none of it.  The same three steps of an eager trainer agree
    at the bf16 bars."""
    from weather_unet_tpu_torch.cli.common import load_step_estimator
    from weather_unet_tpu_torch.data.pipeline import BatchLoader
    from weather_unet_tpu_torch.train.loops import WeatherTransferTrainer

    est = str(tmp_path / "est.pt")
    torch.save(ResNet((2, 2, 2, 2), 5, generator=torch.Generator()
                      .manual_seed(3)).state_dict(), est)
    rng = np.random.default_rng(2)
    data = [(rng.integers(0, 256, (32, 32, 3), np.uint8), True)
            for _ in range(6)]

    def run(name, aot):
        cfg = GanConfig(input_size=32, batch_size=2, gd_train_ratio=2,
                        dtype=torch.bfloat16, num_epoch=1)
        tr = WeatherTransferTrainer(
            cfg, load_step_estimator(est, dtype=torch.bfloat16,
                                     device=cuda),
            save_dir=str(tmp_path / name), log_dir=str(tmp_path / "runs"),
            device=cuda, aot_cache=aot)
        try:
            assert tr.train_epoch(BatchLoader(data, 2), BatchLoader(data, 2))
            torch.cuda.synchronize()
        finally:
            tr.writer.close()
        return tr

    tiered = run("tier", str(tmp_path / "aot"))
    eager = run("eager", None)
    assert (tiered.state.global_step, tiered.state.gen.step,
            tiered.state.disc.step) == (3, 1, 3)
    assert tiered.aot.stats["captures"] == 2
    for a, b in ((tiered.gen, eager.gen), (tiered.disc, eager.disc)):
        for p, q in zip(a.state_dict().values(), b.state_dict().values()):
            if p.is_floating_point():
                assert_close(p, q, torch.bfloat16)


def test_aot_dropout_replays_draw_from_the_generator(cuda, tmp_path):
    """A graphed dropout registers its generator: replays from two seeds
    draw two masks, each the eager draw from that seed, and replays without
    a reseed go on along the generator's stream."""
    from weather_unet_tpu_torch.core.aot import AotCache, AotJit
    from weather_unet_tpu_torch.ops.dropout import bits_dropout

    def program(state, x, generator):
        return bits_dropout(x * state["w"], 0.3, generator)

    cache = AotCache(str(tmp_path))
    graphed = AotJit(program, cache, inplace_argnums=(0,))
    state = {"w": torch.ones((), device=cuda)}
    x = torch.randn(64, 1024, device=cuda) + 3.0
    gen = torch.Generator(device=cuda)
    outs = {}
    for seed in (1, 2):
        gen.manual_seed(seed)
        outs[seed] = graphed(state, x, gen)
    assert not torch.equal(outs[1] != 0, outs[2] != 0)
    for seed, out in outs.items():
        gen.manual_seed(seed)
        assert torch.equal(out, program(state, x, gen))
    assert not torch.equal(graphed(state, x, gen), graphed(state, x, gen))
    assert cache.stats["captures"] == 1


def test_doctor_names_the_card(cuda, capsys):
    import json

    from weather_unet_tpu_torch.cli import doctor

    assert doctor.main(["--json", "--probe"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["backend_ok"] and info["platform"] == "gpu"
    assert info["devices"][0]["name"] == torch.cuda.get_device_name(0)
    # the AOT tier keeps nothing on disk: the doctor reports no cache
    assert info["probe_roundtrip_ms"] > 0 and "aot_cache" not in info


def test_tensor_parallel_on_one_card_matches_unsharded(cuda, tmp_path):
    """``WeatherTransfer`` split over ``["cuda:0", "cuda:0"]`` (two shards
    of one card, in two threads) with K1 and K2: float32 within MAE 1e-5
    of the unsharded ``use_pallas`` forward, 7 model-group sums and 3 K1
    and 3 K2 launches a forward on each shard; the doctor reports the
    split."""
    from weather_unet_tpu_torch.cli import doctor
    from weather_unet_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    path = str(tmp_path / "g.pt")
    torch.save({"inference": ConditionalUNet(5).state_dict(), "epoch": 0,
                "global_step": 0}, path)
    one = WeatherTransfer.load(path, device="cuda")
    two = WeatherTransfer.load(path, plan=make_mesh(
        ["cuda:0", "cuda:0"], model=2), tensor_parallel=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32)).cuda()
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[[0, 1, 2, 3]]).cuda()
    ref = one.translate(x, c)
    k1.launches = k2.launches = 0
    got = two.translate(x, c)
    torch.cuda.synchronize()
    assert (k1.launches, k2.launches) == (6, 6)
    assert two._groups[0].pair_sums == 7
    assert float((got - ref).abs().mean()) <= 1e-5
    info = doctor.collect(tensor_parallel=2)
    assert info["tensor_parallel"]["cUNet"]["split_pairs"][0] == "dconv_down1"


# the decoder's AdaIN and upsample inputs of one shard at 256², B=16 and
# degree 2 (rows 128 of 256), and of 224² at degree 4 (48 or 64 rows)
SPLIT_SITES = [(16, 512, 16, 32), (16, 256, 32, 64), (16, 128, 64, 128),
               (8, 512, 6, 28), (8, 128, 32, 112), (3, 5, 7, 9)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adain_split_form_matches_plain(cuda, dtype):
    """K1's split form at the shards' decoder sites and an odd shape, under
    every plan: the local (mean, M2) against ``ops.norm.plane_stats`` and
    the apply launch, fed two shards' stacked statistics at uneven counts,
    against ``ops.norm.adain_from_shard_stats`` (float32 statistics: the
    mean within 1e-5 of max(1, max |mean|), each plane's M2 within 1e-5 of
    itself; the modulated values at the dtype's bar)."""
    from weather_unet_tpu_torch.ops.norm import (
        adain_from_shard_stats, plane_stats)

    g = torch.Generator(device="cuda").manual_seed(0)
    for b, c, h, w in SPLIT_SITES:
        x = (torch.randn(b, c, h, w, generator=g, device="cuda") * 3
             + 1).to(dtype)
        y = torch.randn(b, 4 * c, generator=g, device="cuda").to(dtype)
        stats = plane_stats(x)
        other = torch.stack([stats[..., 0] + 0.3, stats[..., 1] * 1.5 + 0.1],
                            dim=-1)
        shards = torch.stack([stats, other])
        counts = [h * w, h * w + 7 * w]
        ref = adain_from_shard_stats(x, y, shards, counts, 1e-5)
        for plan in k1.adain_plans(b, c, h, w, dtype):
            got = k1.adain_stats_kernel(x, plan)
            torch.cuda.synchronize()
            assert_stats_close(got, stats)
            out = k1.adain_apply_kernel(x, y, shards, counts, 1e-5, plan)
            torch.cuda.synchronize()
            assert_close(out, ref, dtype)


@pytest.mark.parametrize("n", [2, 3, 4, 14])
def test_adain_apply_merge_is_merge_plane_stats_bitwise(cuda, n):
    """The apply launch's merge of n shards' statistics (uneven rows of a
    67-row plane, each shard's from the stats kernel), under every plan,
    float32 and bfloat16: bit for bit ``ops.norm.merge_plane_stats`` on
    the card; more than 16 shards is refused."""
    from weather_unet_tpu_torch.ops.norm import merge_plane_stats

    g = torch.Generator(device="cuda").manual_seed(n)
    b, c, h, w = 4, 64, 67, 40
    rows = [h // n + (k < h % n) for k in range(n)]
    starts = np.cumsum([0] + rows[:-1])
    counts = [r * w for r in rows]
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn(b, c, h, w, generator=g, device="cuda") * 3
             + 1).to(dtype)
        y = torch.randn(b, 4 * c, generator=g, device="cuda").to(dtype)
        parts = [x[:, :, s:s + r].contiguous() for s, r in zip(starts, rows)]
        shards = torch.stack([k1.adain_stats_kernel(p) for p in parts])
        want = merge_plane_stats(shards, counts)
        for plan in k1.adain_plans(b, c, rows[0], w, dtype):
            _, merged = k1.adain_apply_kernel(parts[0], y, shards, counts,
                                              1e-5, plan, merged=True)
            torch.cuda.synchronize()
            assert torch.equal(merged.view(torch.int32),
                               want.view(torch.int32)), plan["name"]
    with pytest.raises(ValueError, match="1 to 16 shards"):
        k1.adain_apply_kernel(parts[0], y, shards.new_zeros(17, b, c, 2),
                              [w] * 17, 1e-5)


def test_upsample_row_window_matches_plain(cuda):
    """K2's row-window form for every shard at the decoder's upsample
    inputs of 256² at degree 2 and 224² at degree 4, float32 and bfloat16,
    under the blocks of 2048-32768 outputs and the scalar path: against
    ``ops.resize.upsample_x2_rows`` and against the rows of
    ``F.interpolate`` of the whole image."""
    import torch.nn.functional as F

    from weather_unet_tpu_torch.ops.resize import upsample_x2_rows
    from weather_unet_tpu_torch.parallel.mesh import row_cut

    g = torch.Generator(device="cuda").manual_seed(1)
    for size, n, b in ((256, 2, 4), (224, 4, 2)):
        for f, c in ((8, 512), (4, 256), (2, 128)):
            total = size // f
            for dtype in (torch.float32, torch.bfloat16):
                whole = torch.randn(b, c, total, total, generator=g,
                                    device="cuda").to(dtype)
                full = F.interpolate(whole.float(), scale_factor=2,
                                     mode="bilinear", align_corners=True)
                for start0, rows0 in row_cut(size, n):
                    s, h = start0 // f, rows0 // f
                    slab = whole.new_zeros((b, c, h + 2, total))
                    lo, hi = max(s - 1, 0), min(s + h + 1, total)
                    slab[:, :, lo - s + 1:hi - s + 1] = whole[:, :, lo:hi]
                    ref = upsample_x2_rows(slab, total, s)
                    plans = [k2.plan_upsample(b, c, h, total, dtype, opb,
                                              window=(total, s))
                             for opb in (2048, 8192, 32768)]
                    plans.append(k2.plan_upsample(
                        b, c, h, total, dtype, vec_ok=False,
                        window=(total, s)))
                    for plan in plans:
                        got = k2.upsample_rows_kernel(slab, total, s, plan)
                        torch.cuda.synchronize()
                        assert_close(got, ref, dtype)
                    assert_close(got, full[:, :, 2 * s:2 * (s + h)], dtype)


def test_spatial_forward_on_one_card_matches_unsharded(cuda, monkeypatch):
    """The use_pallas cUNet split by height over ``["cuda:0", "cuda:0"]``
    (two shards in two threads) at 64², float32: within MAE 1e-5 of the
    unsharded forward; on each shard a forward launches K1's two split
    launches and K2's row window 3 times each, and no whole-plane K1 or
    whole-image K2; no PyTorch merge of the statistics runs between K1's
    two launches (``ops.norm.merge_plane_stats`` is never called)."""
    from weather_unet_tpu_torch.ops import norm
    from weather_unet_tpu_torch.parallel import spatial
    from weather_unet_tpu_torch.parallel.mesh import (
        make_mesh, put_host_local)

    torch.manual_seed(0)
    model = ConditionalUNet(5, use_pallas=True).cuda().eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(-1, 1, (4, 64, 64, 3)).astype(
        np.float32))
    c = torch.from_numpy(np.eye(5, dtype=np.float32)[[0, 1, 2, 3]])
    with torch.no_grad():
        ref = model(x.permute(0, 3, 1, 2).cuda(), c.cuda()).permute(
            0, 2, 3, 1)
    plan = make_mesh(["cuda:0", "cuda:0"], model=2)
    sm = spatial.SpatialModel(model, plan, 64)
    k1.launches = k2.launches = 0
    k1.stats_launches = k1.apply_launches = k2.rows_launches = 0
    merges = []
    plain_merge = norm.merge_plane_stats

    def counted_merge(*args):
        merges.append(args[1])
        return plain_merge(*args)

    monkeypatch.setattr(norm, "merge_plane_stats", counted_merge)
    got = sm.join(sm(put_host_local(plan.spatial(input_size=64), x), c))
    torch.cuda.synchronize()
    assert (k1.stats_launches, k1.apply_launches, k2.rows_launches) == (
        6, 6, 6)
    assert (k1.launches, k2.launches) == (0, 0)
    assert merges == []
    assert float((got - ref).abs().mean()) <= 1e-5


F1_CHILD = r"""
import hashlib, sys, torch
from weather_unet_tpu_torch._device import refused_allocations
from weather_unet_tpu_torch.models import ResNet
from weather_unet_tpu_torch.cli.common import load_step_estimator
from weather_unet_tpu_torch.train import checkpoint as ckpt
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_gan_step)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
est_path = sys.argv[1]
cfg = GanConfig(input_size=64, batch_size=4)
gen, disc, state = build_gan_state(cfg, 0, "cuda", use_pallas=True)
est = load_step_estimator(est_path, device="cuda", route="k4")
step = make_gan_step(gen, disc, est, cfg)
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.rand(4, 3, 64, 64, generator=g, device="cuda") * 2 - 1
r = torch.rand(4, 3, 64, 64, generator=g, device="cuda") * 2 - 1
z = torch.zeros(4, dtype=torch.int64, device="cuda")
g.manual_seed(2)
st, _ = step(state, x, z, r, z, g, do_g=True)
torch.cuda.synchronize()
tree = ckpt.serialize(ckpt._to_host(ckpt.gan_tree(st, 0)))
print(hashlib.sha256(tree).hexdigest(), refused_allocations())
"""


def test_f32_gan_step_is_reproducible_in_fresh_processes(cuda, tmp_path):
    """Fault F1: the float32 GAN step (use_pallas G, the K4-routed
    estimator, dropout 0.3 from a seeded generator, TF32 off, cuDNN
    deterministic) taken in two fresh processes from the same seeds
    writes the same state bit for bit, and no workspace allocation was
    refused in either (a refused cuDNN workspace runs another engine:
    ``_device.refused_allocations``)."""
    import os
    import subprocess
    import sys

    path = str(tmp_path / "est.pt")
    torch.save(ResNet((1, 1, 1, 1), 5, generator=torch.Generator()
                      .manual_seed(3)).state_dict(), path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    outs = [subprocess.run([sys.executable, "-c", F1_CHILD, path],
                           capture_output=True, text=True, env=env,
                           timeout=300) for _ in range(2)]
    for o in outs:
        assert o.returncode == 0, o.stderr[-3000:]
    got = [o.stdout.split()[-2:] for o in outs]
    assert got[0][1] == got[1][1] == "0", got
    assert got[0][0] == got[1][0], got
