"""The port's reference-surface ops against the JAX package's, on the CPU:
the ``impl=`` forms of the align-corners upsample (``ops/resize.py``), the
whitening ops and ``conditional_norm`` (``ops/norm.py``), ``packed_dropout``
/ ``PackedDropout`` (``ops/dropout.py``) and ``ops/utils_misc.py``.  Inputs
are seeded numpy arrays, transposed between NHWC and NCHW.  The random ops
are held to their rules (rate, scale, lanes, determinism), since their
streams are not JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.ops import norm as jax_norm
from weather_unet_tpu.ops import resize as jax_resize
from weather_unet_tpu.ops import utils_misc as jax_um
from weather_unet_tpu_torch.ops import norm, resize
from weather_unet_tpu_torch.ops import utils_misc as um
from weather_unet_tpu_torch.ops.dropout import PackedDropout, packed_dropout

RESIZE_TOL = 2e-6      # tests/test_kernels.py's bar for the upsample forms
NORM_TOL = 1e-5


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (2, 5, 7, 3),
                                   (1, 1, 9, 4)])
def test_upsample_forms_match_jax(shape):
    """gather and shift, through the impl= switch, against the JAX forms
    and each other in float32 (all built from the same float64 tap tables);
    "matmul" stays F.interpolate (K2's plain version), whose own float32
    taps hold it to the JAX matmul form at the port's resize bar, 1e-5."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    xt = nchw(x)
    plain = F.interpolate(xt, scale_factor=2, mode="bilinear",
                          align_corners=True)
    assert torch.equal(resize.upsample_bilinear_align_corners(xt), plain)
    np.testing.assert_allclose(
        nhwc(plain), np.asarray(jax_resize.upsample_bilinear_align_corners(
            jnp.asarray(x))), atol=1e-5, rtol=0)
    forms = {}
    for impl, fn in (("gather", resize.upsample_x2_gather),
                     ("shift", resize.upsample_x2_shift)):
        forms[impl] = fn(xt)
        assert torch.equal(
            resize.upsample_bilinear_align_corners(xt, impl=impl),
            forms[impl])
        want = np.asarray(jax_resize.upsample_bilinear_align_corners(
            jnp.asarray(x), impl=impl))
        np.testing.assert_allclose(nhwc(forms[impl]), want, atol=RESIZE_TOL,
                                   rtol=0)
    np.testing.assert_allclose(forms["gather"].numpy(),
                               forms["shift"].numpy(), atol=RESIZE_TOL,
                               rtol=0)
    with pytest.raises(ValueError, match="impl"):
        resize.upsample_bilinear_align_corners(xt, impl="einsum")


def test_upsample_forms_bf16_round_where_jax_rounds():
    """gather blends in bfloat16 (each product and sum rounds); shift runs
    each axis in float32 and rounds after it.  With JAX's rounding points
    the bfloat16 results equal the JAX package's bit for bit on the CPU,
    and each stays within 2^-6 * max of its own float32 result."""
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 10)).astype(
        np.float32)
    xb = nchw(x).to(torch.bfloat16)
    for impl in ("gather", "shift"):
        out = resize.upsample_bilinear_align_corners(xb, impl=impl)
        assert out.dtype == torch.bfloat16
        want = jax_resize.upsample_bilinear_align_corners(
            jnp.asarray(x, jnp.bfloat16), impl=impl).astype(jnp.float32)
        np.testing.assert_array_equal(nhwc(out.float()), np.asarray(want))
        ref = resize.upsample_bilinear_align_corners(xb.float(), impl=impl)
        err = float((out.float() - ref).abs().max())
        assert err <= 2.0 ** -6 * float(ref.abs().max())


# -------------------------------------------------------------------- norm

def test_whitening_and_conditional_norm_match_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 12, 10, 6)) * 2 + 1).astype(np.float32)
    xt = nchw(x)
    np.testing.assert_allclose(
        nhwc(norm.instance_whiten(xt)),
        np.asarray(jax_norm.instance_whiten(jnp.asarray(x))),
        atol=NORM_TOL, rtol=0)
    np.testing.assert_allclose(
        nhwc(norm.batch_whiten(xt)),
        np.asarray(jax_norm.batch_whiten(jnp.asarray(x))),
        atol=NORM_TOL, rtol=0)
    mean = rng.standard_normal(6).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    gamma = rng.standard_normal((3, 6)).astype(np.float32)
    beta = rng.standard_normal((3, 6)).astype(np.float32)
    out = norm.conditional_norm(xt, *map(torch.from_numpy,
                                         (mean, var, gamma, beta)))
    want = jax_norm.conditional_norm(jnp.asarray(x), *map(
        jnp.asarray, (mean, var, gamma, beta)))
    np.testing.assert_allclose(nhwc(out), np.asarray(want), atol=NORM_TOL,
                               rtol=0)
    xb = xt.to(torch.bfloat16)
    for fn in (norm.instance_whiten, norm.batch_whiten):
        assert fn(xb).dtype == torch.bfloat16


# ----------------------------------------------------------------- dropout

def test_packed_drop_rate_scale_and_lanes():
    """The keep share is thresh/256, kept values are x * 256/thresh, the
    mean is kept; and the mask is the lane rule itself: word j of a pixel
    decides channels 4j..4j+3, lane k (bits 8k..8k+7) channel 4j+k."""
    x = torch.ones((64, 64, 32, 32))
    y = packed_dropout(x, 0.3, gen(0))
    thresh = round(0.7 * 256)                 # 179
    keep_actual = thresh / 256.0
    assert abs(float((y == 0).float().mean()) - (1 - keep_actual)) < 5e-3
    torch.testing.assert_close(y[y != 0], torch.full_like(
        y[y != 0], 1.0 / keep_actual), rtol=1e-6, atol=0)
    assert abs(float(y.mean()) - 1.0) < 5e-3
    xs = torch.randn((2, 8, 3, 5), generator=gen(9))
    out = packed_dropout(xs, 0.3, gen(5))
    words = torch.randint(-2 ** 31, 2 ** 31, (2, 2, 3, 5), generator=gen(5),
                          dtype=torch.int32).numpy()
    lanes = words.view(np.uint8).reshape(2, 2, 3, 5, 4)  # little-endian bytes
    keep = np.moveaxis(lanes, 4, 2).reshape(2, 8, 3, 5) < thresh
    scale = torch.tensor(256.0 / thresh)
    want = torch.where(torch.from_numpy(keep), xs * scale, torch.zeros(()))
    assert torch.equal(out, want)


def test_packed_deterministic_per_generator_and_distinct_across():
    x = torch.arange(4 * 16 * 8 * 8, dtype=torch.float32).reshape(4, 16, 8, 8)
    a = packed_dropout(x, 0.3, gen(1))
    b = packed_dropout(x, 0.3, gen(1))
    c = packed_dropout(x, 0.3, gen(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    xb = torch.ones((8, 32, 16, 16), dtype=torch.bfloat16)
    yb = packed_dropout(xb, 0.3, gen(3))
    assert yb.dtype == torch.bfloat16
    assert 0.0 < float((yb == 0).float().mean()) < 0.6
    # the scale is rounded to x's dtype, as in the JAX package
    kept = yb[yb != 0]
    assert torch.equal(kept, torch.full_like(kept, 256.0 / 179))


@pytest.mark.parametrize("case", ["odd_channels", "extreme_rate"])
def test_packed_fallbacks(case):
    """C % 4 != 0 and a rate whose thresh rounds to 0 take the Bernoulli
    rule (keep 1 - rate, scale 1 / (1 - rate))."""
    if case == "odd_channels":
        y = packed_dropout(torch.ones((64, 3, 16, 16)), 0.3, gen(4))
        assert abs(float((y == 0).float().mean()) - 0.3) < 2e-2
        torch.testing.assert_close(y[y != 0], torch.full_like(
            y[y != 0], 1.0 / 0.7), rtol=1e-5, atol=0)
    else:
        y = packed_dropout(torch.ones((32, 8, 8, 8)), 0.999, gen(5))
        assert float((y == 0).float().mean()) > 0.99


def test_packed_gradient_is_mask_times_scale():
    x = torch.ones((2, 8, 4, 4), requires_grad=True)
    packed_dropout(x, 0.3, gen(6)).sum().backward()
    y = packed_dropout(torch.ones((2, 8, 4, 4)), 0.3, gen(6))
    torch.testing.assert_close(x.grad, y, rtol=1e-6, atol=0)


def test_packed_module_identity_at_rate_zero_and_deterministic():
    x = torch.ones((2, 8, 4, 4))
    assert PackedDropout(0.0)(x, gen(0)) is x
    assert PackedDropout(0.3, deterministic=True)(x) is x
    assert packed_dropout(x, 0.0, gen(0)) is x
    assert torch.equal(PackedDropout(0.3)(x, gen(7)),
                       packed_dropout(x, 0.3, gen(7)))


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_packed_mean_preserved_various_rates(rate):
    x = torch.randn((32, 32, 16, 16), generator=gen(8))
    y = packed_dropout(x, rate, gen(7))
    assert abs(float(y.mean()) - float(x.mean())) < 2e-2


# -------------------------------------------------------------- utils_misc

def test_deterministic_utils_equal_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    oh = um.make_one_hot(torch.from_numpy(x), 16)
    assert oh.dtype == torch.int32
    np.testing.assert_array_equal(
        oh.numpy(), np.asarray(jax_um.make_one_hot(jnp.asarray(x), 16)))
    # an index beyond num_classes gives zeros, as jax.nn.one_hot does
    np.testing.assert_array_equal(
        um.make_one_hot(torch.from_numpy(x), 2).numpy(),
        np.asarray(jax_um.make_one_hot(jnp.asarray(x), 2)))
    for v in (x[0], x):
        got = um.vector_to_one_hot(torch.from_numpy(v))
        want = np.asarray(jax_um.vector_to_one_hot(jnp.asarray(v)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    img = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    mean, std = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
    for m, s in ((0.5, 0.5), (mean, std)):
        np.testing.assert_array_equal(
            nhwc(um.denormalize(nchw(img), m, s)),
            np.asarray(jax_um.denormalize(jnp.asarray(img), m, s)))
    for one_hot in (False, True):
        np.testing.assert_array_equal(
            um.get_sequential_labels(5, 8, one_hot, device="cpu").numpy(),
            np.asarray(jax_um.get_sequential_labels(5, 8, one_hot)))
    np.testing.assert_array_equal(
        um.const_batch(1.0, 4, device="cpu").numpy(),
        np.asarray(jax_um.const_batch(1.0, 4)))
    for args in ((50, 100), (50, 100, 0.3), (3, 0)):
        assert um.lmda_ramp(*args) == jax_um.lmda_ramp(*args)


def test_random_utils_follow_their_rules():
    """half_dropout drops only the first half of dim 1 (kept values scaled
    by 1 / (1 - rate)); get_rand_labels is uniform in [-1, 1); both are
    fixed by their generator; the makers of new tensors default to the
    GPU and raise without one."""
    x = torch.ones((2, 8, 4, 4))
    out = um.half_dropout(x, rate=0.5, generator=gen(0))
    assert torch.equal(out[:, 4:], x[:, 4:])
    front = out[:, :4]
    assert bool((front == 0).any()) and bool((front == 2.0).any())
    assert set(front.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(out, um.half_dropout(x, 0.5, generator=gen(0)))
    assert um.half_dropout(x, 0.5, deterministic=True) is x
    lb = um.get_rand_labels(5, 8, gen(1), device="cpu")
    assert lb.shape == (8, 5) and lb.dtype == torch.float32
    assert float(lb.min()) >= -1.0 and float(lb.max()) < 1.0
    assert torch.equal(lb, um.get_rand_labels(5, 8, gen(1), device="cpu"))
    jl = jax_um.get_rand_labels(jax.random.key(0), 5, 8)
    assert lb.shape == jl.shape and lb.numpy().dtype == jl.dtype
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            um.const_batch(1.0, 4)
