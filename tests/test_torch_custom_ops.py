"""K1 and K2 as ``torch.library`` custom ops (``wut::adain``,
``wut::upsample2x``) on the CPU: ``torch.library.opcheck`` (schema, fake
implementation, autograd registration, tracing with dynamic shapes), and
``adain_fused`` / ``upsample2x_fused`` bit-equal, forward and gradients, to
the ``torch.autograd.Function``s they replaced (copied below as they were).
The CUDA implementations, which launch the kernels, are held to the plain
versions in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu_torch.kernels import adain as k1, upsample as k2
from weather_unet_tpu_torch.ops.norm import adain
from weather_unet_tpu_torch.ops.resize import upsample_bilinear_align_corners


class AdaINFunction(torch.autograd.Function):
    """K1's wrapper before it became a registered op (CPU path)."""

    @staticmethod
    def forward(ctx, x, y_proj, eps):
        ctx.save_for_backward(x, y_proj)
        ctx.eps = eps
        return adain(x, y_proj, eps)

    @staticmethod
    def backward(ctx, g):
        x, y_proj = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            yy = y_proj.detach().requires_grad_()
            gx, gy = torch.autograd.grad(adain(xx, yy, ctx.eps), (xx, yy), g)
        return gx, gy, None


class Upsample2xFunction(torch.autograd.Function):
    """K2's wrapper before it became a registered op (CPU path)."""

    @staticmethod
    def forward(ctx, x):
        ctx.hw = x.shape[2:]
        return upsample_bilinear_align_corners(x)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.hw
        mh = k2._interp_matrix(h, g.device).to(g.dtype)
        mw = k2._interp_matrix(w, g.device).to(g.dtype)
        return torch.einsum("oh,bcop,pw->bchw", mh, g, mw)


def inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, 5, 7, generator=g).to(dtype)
    y = torch.randn(2, 24, generator=g).to(dtype)
    return x, y


@pytest.mark.parametrize("op", ["adain", "upsample2x"])
def test_opcheck(op):
    x, y = inputs(torch.float32)
    if op == "adain":
        cases = [(x.requires_grad_(), y.requires_grad_(), 1e-5),
                 (x[:, :, :, :6], y, 1e-3)]          # a strided input
        for args in cases:
            torch.library.opcheck(k1.adain_op, args)
    else:
        for args in ((x.requires_grad_(),), (x.transpose(2, 3),)):
            torch.library.opcheck(k2.upsample2x_op, args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bit_equal_to_the_autograd_functions(dtype):
    launched = k1.launches, k2.launches
    x, y = inputs(dtype, 1)
    g_out = torch.randn(2, 6, 5, 7, generator=torch.Generator().manual_seed(2))
    results = []
    for fn in (k1.adain_fused, lambda a, b, e: AdaINFunction.apply(a, b, e)):
        xx, yy = x.clone().requires_grad_(), y.clone().requires_grad_()
        out = fn(xx, yy, 1e-5)
        out.backward(g_out.to(dtype))
        results.append((out, xx.grad, yy.grad))
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)

    g_up = torch.randn(2, 6, 10, 14,
                       generator=torch.Generator().manual_seed(3))
    results = []
    for fn in (k2.upsample2x_fused, Upsample2xFunction.apply):
        xx = x.clone().requires_grad_()
        out = fn(xx)
        out.backward(g_up.to(dtype))
        results.append((out, xx.grad))
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # no kernel runs on the CPU, so nothing is counted
    assert (k1.launches, k2.launches) == launched


def test_tracing_keeps_one_op_and_other_devices_are_refused():
    class Block(torch.nn.Module):
        def forward(self, x, y):
            return k2.upsample2x_fused(k1.adain_fused(x, y))

    x, y = inputs(torch.float32)
    b = torch.export.Dim("b", min=1)
    with torch.no_grad():
        program = torch.export.export(Block(), (x, y),
                                      dynamic_shapes=({0: b}, {0: b}))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets == ["wut.adain.default", "wut.upsample2x.default"]
    one = program.module()(x[:1], y[:1])
    np.testing.assert_array_equal(
        one.numpy(), upsample_bilinear_align_corners(adain(x[:1], y[:1]))
        .numpy())
    for fn, args in ((k1.adain_fused, (x.to("meta"), y.to("meta"))),
                     (k2.upsample2x_fused, (x.to("meta"),))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args)
