"""K1, K2 and K3 as ``torch.library`` custom ops (``wut::adain``,
``wut::upsample2x``, ``wut::upconv``, and the split forms
``wut::adain_stats``, ``wut::adain_apply``, ``wut::upsample2x_rows``) on
the CPU: ``torch.library.opcheck``
(schema, fake implementation, autograd registration, tracing with dynamic
shapes), and ``adain_fused`` / ``upsample2x_fused`` /
``upsample2x_conv3x3`` bit-equal, forward and gradients, to the
``torch.autograd.Function``s they replaced (copied below as they were).
The CUDA implementations, which launch the kernels, are held to the plain
versions in ``tests/test_torch_gpu.py``."""

import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu_torch.kernels import (
    adain as k1, upconv as k3, upsample as k2)
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


class UpConvFunction(torch.autograd.Function):
    """K3's wrapper before it became a registered op (CPU path)."""

    @staticmethod
    def forward(ctx, x, weight, cb, scale, shift, relu):
        ctx.save_for_backward(x, weight, cb, scale, shift)
        ctx.relu = relu
        return k3.upsample2x_conv3x3_ref(x, weight, cb=cb, scale=scale,
                                         shift=shift, relu=relu)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad[:5]
        with torch.enable_grad():
            args = [None if t is None else t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, needs)]
            out = k3.upsample2x_conv3x3_ref(args[0], args[1], cb=args[2],
                                            scale=args[3], shift=args[4],
                                            relu=ctx.relu)
            wrt = [a for a, n in zip(args, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if n else None for n in needs) + (None,)


def upconv_inputs(dtype, seed=4):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, 6, 5, 7, generator=g).to(dtype),
            (0.2 * torch.randn(4, 6, 3, 3, generator=g)).to(dtype),
            torch.randn(2, 4, 10, 14, generator=g).to(dtype),
            torch.rand(2, 6, generator=g) + 0.5,
            torch.randn(2, 6, generator=g))


def inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, 5, 7, generator=g).to(dtype)
    y = torch.randn(2, 24, generator=g).to(dtype)
    return x, y


@pytest.mark.parametrize("op", ["adain", "upsample2x", "upconv"])
def test_opcheck(op):
    x, y = inputs(torch.float32)
    if op == "upconv":
        ux, w, cb, sc, sh = upconv_inputs(torch.float32)
        for args in ((ux.requires_grad_(), w.requires_grad_(),
                      cb.requires_grad_(), sc, sh, True),
                     (ux[:, :, :, :6], w, None, None, None, False)):
            torch.library.opcheck(k3.upconv_op, args)
    elif op == "adain":
        cases = [(x.requires_grad_(), y.requires_grad_(), 1e-5),
                 (x[:, :, :, :6], y, 1e-3)]          # a strided input
        for args in cases:
            torch.library.opcheck(k1.adain_op, args)
    else:
        for args in ((x.requires_grad_(),), (x.transpose(2, 3),)):
            torch.library.opcheck(k2.upsample2x_op, args)


@pytest.mark.parametrize("op", ["adain_stats", "adain_apply",
                                "upsample2x_rows"])
def test_opcheck_split_forms(op):
    """K1's split-statistics ops and K2's row-window op (spatial
    partitioning) pass ``opcheck`` too, a strided input included; their
    gradients recompute through the plain pieces."""
    x, y = inputs(torch.float32)
    if op == "adain_stats":
        for args in ((x.requires_grad_(),), (x[:, :, :, :6],)):
            torch.library.opcheck(k1.adain_stats_op, args)
    elif op == "adain_apply":
        # two shards' stacked local (mean, M2) at uneven counts
        st = torch.stack([torch.stack([x.mean(dim=(2, 3)) + d,
                                       x.var(dim=(2, 3)) * n + 0.5], dim=-1)
                          for d, n in ((0.0, 20), (0.3, 30))]).detach()
        for args in ((x.requires_grad_(), y.requires_grad_(),
                      st.clone().requires_grad_(), [21, 31], 1e-5),
                     (x[:, :, :, :6], y, st, [21, 31], 1e-3),
                     (x.detach(), y, st.transpose(1, 2).contiguous()
                      .transpose(1, 2), [21, 31], 1e-5)):
            torch.library.opcheck(k1.adain_apply_op, args)
    else:
        slab = torch.randn(2, 6, 6, 7)          # rows [4, 8) of 12, halo'd
        for args in ((slab.requires_grad_(), 12, 4),
                     (slab.transpose(2, 3).transpose(2, 3)[:, :, :, :6],
                      12, 0)):
            torch.library.opcheck(k2.upsample2x_rows_op, args)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_op_bit_equal_to_the_autograd_function(dtype):
    """K3 became ``wut::upconv`` so that a ``fuse_upconv`` forward exports
    (the AOT tier's disk entries): forward and every gradient unchanged."""
    launched = k3.launches
    x, w, cb, sc, sh = upconv_inputs(dtype)
    g_out = torch.randn(2, 4, 10, 14,
                        generator=torch.Generator().manual_seed(5)).to(dtype)
    results = []
    for fn in (lambda *a: k3.upsample2x_conv3x3(
            a[0], a[1], cb=a[2], scale=a[3], shift=a[4], relu=True),
               lambda *a: UpConvFunction.apply(*a, True)):
        args = [t.clone().requires_grad_() for t in (x, w, cb, sc, sh)]
        out = fn(*args)
        out.backward(g_out)
        results.append((out, *(a.grad for a in args)))
    for got, want in zip(*results):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert k3.launches == launched


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
