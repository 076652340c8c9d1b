"""K4 on the CPU (weather_unet_tpu_torch.kernels.bottleneck): BN folding, the
kernel's plain version and the whole fused ResNet forward against the JAX
package, with its Pallas kernel run in interpret mode; and the Python around
the CUDA launch.  The kernel itself runs in tests/test_torch_gpu.py.
Tolerances: 1e-6 on folded weights, 1e-5 on one block, 2e-4 on logits (the
bars of tests/test_kernels.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_resnet import (
    COUNTS, jax_resnet_variables, port_resnet)
from tests.torch_port_util import nchw, nhwc, one_torch_thread  # noqa: F401
from weather_unet_tpu.kernels import bottleneck_pallas as jax_k4
from weather_unet_tpu_torch.kernels import bottleneck as k4


@pytest.fixture(scope="module")
def setup():
    model, variables = jax_resnet_variables()
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    return variables, port_resnet(variables).eval(), x, want


@pytest.fixture(scope="module")
def block(setup):
    """layer1's identity block: JAX-folded and port-folded weights, and an
    input of its shape (C=256, P=64)."""
    variables, model, _, _ = setup
    want = jax_k4.fold_bottleneck(variables["params"]["layer1_1"],
                                  variables["batch_stats"]["layer1_1"])
    got = k4.fold_bottleneck(model.layer1[1].state_dict())
    x = np.random.default_rng(4).standard_normal((2, 6, 5, 256)).astype(
        np.float32)
    return want, got, x


def test_fold_bottleneck_matches_jax(block):
    want, got, _ = block
    assert [tuple(a.shape) for a in got] == [
        (256, 64), (64,), (9, 64, 64), (64,), (64, 256), (256,)]
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert all(float(b.abs().min()) > 0 for b in got[1::2])   # non-zero biases


def test_reference_matches_pallas_interpret(rng):
    # (2, 14, 14, 64), P=16, the shape of tests/test_kernels.py, with biases
    # well away from zero: a halo of relu(b1) instead of 0 would show
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
    args = [torch.from_numpy(a) for a in (w1, b1, w2, b2, w3, b3)]
    got = k4.bottleneck_eval_reference(nchw(x), *args)
    np.testing.assert_allclose(nhwc(got), want, atol=1e-5)
    np.testing.assert_allclose(
        nhwc(got), np.asarray(jax_k4.bottleneck_eval_reference(
            *(jnp.asarray(a) for a in (x, w1, b1, w2, b2, w3, b3)))),
        atol=1e-5)


def test_reference_pads_t1_with_zero_not_relu_b1():
    # x = 0 and w1 = 0 make t1 = relu(b1) = 2 inside the image; with w2 = 1
    # a pixel's t2 counts its in-image neighbours: 9 inside, 6 on an edge, 4
    # in a corner.  A halo computed from a zero input would give 9 everywhere.
    c, p = 4, 4
    x = torch.zeros(1, c, 5, 6)
    w1, w2 = torch.zeros(c, p), torch.ones(9, p, p)
    w3 = torch.eye(p, c)
    b1, zero = torch.full((p,), 2.0), torch.zeros(p)
    out = k4.bottleneck_eval_reference(x, w1, b1, w2, zero, w3, zero)
    assert float(out[0, 0, 2, 3]) == 9 * p * 2.0
    assert float(out[0, 0, 0, 3]) == 6 * p * 2.0
    assert float(out[0, 0, 4, 5]) == 4 * p * 2.0


def test_bf16_reference_rounds_where_the_kernel_does(block):
    _, w, x = block
    xb = nchw(x).bfloat16()
    got = k4.fused_bottleneck_eval(xb, *w)      # weights cast by the wrapper
    assert got.dtype == torch.bfloat16
    # the same arithmetic spelled out: operands rounded to bf16, float32
    # sums, t1 and t2 rounded to bf16
    r = lambda t: t.bfloat16().float()
    xf = xb.float()
    t1 = r(torch.relu(torch.einsum("bchw,cp->bphw", xf, r(w[0]))
                      + w[1][None, :, None, None]))
    k2 = r(w[2]).reshape(3, 3, 64, 64).permute(3, 2, 0, 1)
    t2 = r(torch.relu(torch.nn.functional.conv2d(t1, k2, padding=1)
                      + w[3][None, :, None, None]))
    y = (torch.einsum("bphw,pc->bchw", t2, r(w[4]))
         + w[5][None, :, None, None] + xf)
    want = torch.relu(y).bfloat16()
    # float32 summation order may flip one bf16 rounding of t1/t2
    assert float((got.float() - want.float()).abs().max()) <= 2.0 ** -6 * max(
        1.0, float(want.float().abs().max()))
    f32 = k4.fused_bottleneck_eval(nchw(x), *w)
    assert float((got.float() - f32).abs().mean()) < 0.05


@pytest.mark.parametrize("fuse_layers", [(1,), ()], ids=["layer1", "none"])
def test_fused_resnet_eval_matches_jax(setup, fuse_layers):
    variables, model, x, want = setup
    fused_jax = np.asarray(jax_k4.fused_resnet_eval(
        variables, block_counts=COUNTS, fuse_layers=fuse_layers,
        interpret=True)(jnp.asarray(x)))
    calls = []
    orig = k4.fused_bottleneck_eval
    k4.fused_bottleneck_eval = lambda *a: calls.append(a[0].shape) or orig(*a)
    try:
        got = k4.fused_resnet_eval(model, fuse_layers)(nchw(x))
    finally:
        k4.fused_bottleneck_eval = orig
    assert got.shape == (2, 7) and got.dtype == torch.float32
    assert calls == [(2, 256, 8, 8)] * len(fuse_layers)   # layer1's one block
    np.testing.assert_allclose(got.numpy(), fused_jax, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), model(nchw(x)).numpy(),
                                   atol=2e-4)


def test_cpu_runs_plain_and_counts_nothing(block):
    _, w, x = block
    before = k4.launches
    assert torch.equal(k4.fused_bottleneck_eval(nchw(x), *w),
                       k4.bottleneck_eval_reference(nchw(x), *w))
    assert k4.launches == before
    with pytest.raises(ValueError, match="device"):
        k4.fused_bottleneck_eval(torch.zeros(1, 8, 2, 2, device="meta"),
                                 *(t.to("meta") for t in w))


def test_kernel_refuses_what_it_cannot_take(block):
    _, w, x = block
    xt = nchw(x)
    with pytest.raises(ValueError, match="CUDA"):
        k4.bottleneck_kernel(xt, *w)                 # CPU tensors
    with pytest.raises(ValueError, match="float32"):
        k4.bottleneck_kernel(xt.double(), *w)
    with pytest.raises(ValueError, match="w2"):
        k4.bottleneck_kernel(xt, w[0], w[1], w[2][:8], *w[3:])
    with pytest.raises(ValueError, match="b3"):
        k4.bottleneck_kernel(xt, *w[:5], w[5].double())
    with pytest.raises(ValueError, match="multiples of 4"):
        k4.bottleneck_kernel(torch.zeros(1, 6, 2, 2), torch.zeros(6, 2),
                             *w[1:])
