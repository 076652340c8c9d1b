"""K2 on the CPU (weather_unet_tpu_torch.kernels.upsample): the plain version
and the autograd backward against the JAX package's Pallas kernel run in
interpret mode and its VJP, the Python around the CUDA launch, and the
cUNet's use_pallas routing.  The kernel itself runs in
tests/test_torch_gpu.py.  Tolerances: the kernel's arithmetic (a float32 2x2
blend with the tap tables it reads, rebuilt here in numpy) 2e-6 forward and
the backward 2e-5, the bars of tests/test_kernels.py; the plain version,
``F.interpolate``, 1e-5, the bar of tests/test_torch_resize.py: PyTorch
computes its blend weights in float32 from ``i * (n_in - 1) / (n_out - 1)``,
which puts it up to 5e-6 from the exact float64 tables on N(0, 1) inputs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.kernels.upsample_pallas import (
    upsample2x_fused as jax_upsample2x_fused)
from weather_unet_tpu_torch.kernels import upconv as k3, upsample as k2
from weather_unet_tpu_torch.models import ConditionalUNet, cunet
from weather_unet_tpu_torch.ops import resize


def table_blend(x: np.ndarray) -> np.ndarray:
    """The arithmetic the kernel does on NCHW ``x``, from the tables it
    reads."""
    h, w = x.shape[2:]
    idx, frac = resize._tap_tables(h, w, torch.device("cpu"))
    idx, frac = idx.numpy(), frac.numpy()
    i0, i1, j0, j1 = np.split(idx, [2 * h, 4 * h, 4 * h + 2 * w])
    fy, fx = frac[:2 * h, None], frac[None, 2 * h:]
    top = (1 - fx) * x[:, :, i0][..., j0] + fx * x[:, :, i0][..., j1]
    bot = (1 - fx) * x[:, :, i1][..., j0] + fx * x[:, :, i1][..., j1]
    return (1 - fy) * top + fy * bot


@pytest.mark.parametrize("size", [16, 17])
def test_forward_and_backward_match_jax_pallas(rng, size):
    x = rng.standard_normal((2, size, size, 8)).astype(np.float32)
    want = np.asarray(jax_upsample2x_fused(jnp.asarray(x), "shift", True))
    want_grad = np.asarray(jax.grad(lambda a: jnp.sum(jnp.sin(
        jax_upsample2x_fused(a, "shift", True))))(jnp.asarray(x)))
    xt = nchw(x).requires_grad_()
    got = k2.upsample2x_fused(xt)
    assert got.shape == (2, 8, 2 * size, 2 * size)
    np.testing.assert_allclose(
        np.transpose(table_blend(nchw(x).numpy()), (0, 2, 3, 1)), want,
        atol=2e-6)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    np.testing.assert_allclose(nhwc(k2.upsample2x_fused_ref(xt)), want,
                               atol=1e-5)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), want_grad, atol=2e-5)


def test_backward_is_the_transposed_interpolation(rng):
    # odd sizes, H != W; against autograd through the plain version
    x = torch.from_numpy(rng.standard_normal((2, 8, 5, 7)).astype(np.float32))
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 8, 10, 14)).astype(
        np.float32))
    k2.upsample2x_fused(a).backward(g)
    k2.upsample2x_fused_ref(b).backward(g)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-5)
    # a sum of outputs = x weighted by the column sums of the matrices
    mh = resize._interp_matrix_np(10, 5, True)
    mw = resize._interp_matrix_np(14, 7, True)
    c = x.clone().requires_grad_()
    k2.upsample2x_fused(c).sum().backward()
    np.testing.assert_allclose(c.grad[0, 0].numpy(),
                               np.outer(mh.sum(0), mw.sum(0)), atol=1e-5)


def test_degenerate_and_odd_sizes_match_the_tap_tables(rng):
    for shape in ((1, 2, 1, 6), (1, 2, 6, 1), (1, 1, 1, 1), (2, 8, 5, 7)):
        x = rng.standard_normal(shape).astype(np.float32)
        got = k2.upsample2x_fused(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), table_blend(x), atol=2e-6)


def test_variant_is_checked_and_otherwise_ignored(rng):
    x = torch.from_numpy(rng.standard_normal((1, 2, 4, 4)).astype(np.float32))
    outs = [k2.upsample2x_fused(x, v) for v in k2.VARIANTS]
    assert k2.VARIANTS == ("einsum", "loop", "blend", "blendmm", "shift")
    assert all(torch.equal(o, outs[0]) for o in outs)
    with pytest.raises(ValueError, match="variant"):
        k2.upsample2x_fused(x, "bicubic")


def test_cpu_runs_plain_and_kernel_refuses_what_it_cannot_take(rng):
    x = torch.from_numpy(rng.standard_normal((2, 3, 4, 5)).astype(np.float32))
    before = k2.launches
    assert torch.equal(k2.upsample2x_fused(x), k2.upsample2x_fused_ref(x))
    # a channels-last input gives the same values
    cl = x.contiguous(memory_format=torch.channels_last)
    assert torch.equal(k2.upsample2x_fused(cl), k2.upsample2x_fused_ref(x))
    assert k2.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        k2.upsample_kernel(x)                        # a CPU tensor
    with pytest.raises(ValueError, match="float32"):
        k2.upsample_kernel(x.double())
    with pytest.raises(ValueError, match="4-D"):
        k2.upsample_kernel(x[0])
    with pytest.raises(ValueError, match="device"):
        k2.upsample2x_fused(x.to("meta"))
    # one table code for K2 and K3
    assert k3._tap_tables is resize._tap_tables


@pytest.mark.parametrize("config,calls", [
    ({"use_pallas": True}, 3), ({"use_pallas": True, "fuse_upconv": (3,)}, 2)],
    ids=["use_pallas", "use_pallas_fuse_level_3"])
def test_cunet_use_pallas_routes_the_unfused_upsamples(rng, monkeypatch,
                                                      config, calls):
    seen = []
    orig = k2.upsample2x_fused
    monkeypatch.setattr(cunet, "upsample2x_fused",
                        lambda x: seen.append(x.shape[1]) or orig(x))
    torch.manual_seed(0)
    model = ConditionalUNet(5, **config).eval()
    plain = ConditionalUNet(5).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 16, 16)).astype(
        np.float32))
    c = torch.eye(5)[[2]]
    with torch.no_grad():
        got, want = model(x, c), plain(x, c)
    assert seen == [512, 256, 128][3 - calls:]
    assert float((got - want).abs().mean()) < 1e-5
