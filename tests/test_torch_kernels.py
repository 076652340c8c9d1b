"""The port's kernel modules (weather_unet_tpu_torch.kernels): K1's plain
version and autograd against the JAX package's Pallas kernel run in
interpret mode, and the Python around both CUDA launches: dispatch by
device, launch counters, argument checks and the build.  K3's arithmetic is
held to the JAX package in tests/test_torch_upconv.py; the kernels
themselves run in tests/test_torch_gpu.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    block_inputs, nchw, nhwc, no_thread_left, oihw, one_torch_thread)
from weather_unet_tpu.kernels import adain_pallas
from weather_unet_tpu_torch.kernels import _build, adain as k1, upconv as k3


# ------------------------------------------------------------------ K1

def test_adain_plain_matches_pallas_interpret(rng):
    x = rng.standard_normal((3, 16, 16, 32)).astype(np.float32)
    y = rng.standard_normal((3, 128)).astype(np.float32)
    want = np.asarray(adain_pallas.adain_fused(jnp.asarray(x), jnp.asarray(y),
                                               1e-5, True))
    got = nhwc(k1.adain_fused(nchw(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_adain_grads_match_pallas_vjp(rng):
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    y = rng.standard_normal((2, 64)).astype(np.float32)
    gj = jax.grad(lambda a, b: jnp.sum(jnp.sin(
        adain_pallas.adain_fused(a, b, 1e-5, True))), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(y))
    xt = nchw(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    torch.sin(k1.adain_fused(xt, yt)).sum().backward()
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(gj[0]), atol=1e-5)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gj[1]), atol=1e-4)


def test_adain_cpu_runs_plain_and_counts_nothing(rng):
    x = torch.from_numpy(rng.standard_normal((2, 4, 5, 7)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    before = k1.launches
    assert torch.equal(k1.adain_fused(x, y), k1.adain_fused_ref(x, y))
    assert k1.launches == before


def test_adain_kernel_refuses_what_it_cannot_take():
    x = torch.zeros(2, 4, 3, 3)
    y = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        k1.adain_kernel(x, y, 1e-5)                  # CPU tensors
    with pytest.raises(ValueError, match="float32"):
        k1.adain_kernel(x.double(), y, 1e-5)
    with pytest.raises(ValueError, match="y_proj"):
        k1.adain_kernel(x, torch.zeros(2, 5), 1e-5)
    with pytest.raises(ValueError, match="device"):
        k1.adain_fused(x.to("meta"), torch.zeros(2, 16, device="meta"))


# ------------------------------------------------------------------ K3

def test_upconv_cpu_runs_plain_and_counts_nothing(rng):
    x, k, cb, sc, sh = block_inputs(rng, h=4, w=5, c=3, o=2)
    t = (nchw(x), oihw(k), nchw(cb), torch.from_numpy(sc), torch.from_numpy(sh))
    before = k3.launches
    for kw in ({}, {"cb": t[2]}, {"scale": t[3], "shift": t[4], "relu": True}):
        assert torch.equal(k3.upsample2x_conv3x3(t[0], t[1], **kw),
                           k3.upsample2x_conv3x3_ref(t[0], t[1], **kw))
    assert k3.launches == before


def test_upconv_kernel_refuses_what_it_cannot_take():
    x, w = torch.zeros(1, 4, 3, 3), torch.zeros(2, 4, 3, 3)
    with pytest.raises(ValueError, match="CUDA"):
        k3.upconv_kernel(x, w)                       # CPU tensors
    with pytest.raises(ValueError, match="weight"):
        k3.upconv_kernel(x, torch.zeros(2, 5, 3, 3))
    with pytest.raises(ValueError, match="together"):
        k3.upconv_kernel(x, w, scale=torch.zeros(1, 4))
    with pytest.raises(ValueError, match="cb"):
        k3.upconv_kernel(x, w, cb=torch.zeros(1, 2, 6, 5))


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
