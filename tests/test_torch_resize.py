"""The port's resampling ops against the JAX package's on the CPU: the 2x
align-corners bilinear upsample (weather_unet_tpu_torch.ops.resize) and the
2x2 max-pool (weather_unet_tpu_torch.ops.convs)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.ops import convs as jconvs
from weather_unet_tpu.ops import resize as jresize
from weather_unet_tpu_torch.ops import convs, resize


@pytest.mark.parametrize("hw", [(32, 32), (17, 17), (5, 7), (4, 4), (1, 3)])
def test_upsample_matches_jax(rng, hw):
    x = rng.standard_normal((2,) + hw + (8,)).astype(np.float32)
    want = np.asarray(jresize.upsample_bilinear_align_corners(jnp.asarray(x)))
    got = nhwc(resize.upsample_bilinear_align_corners(nchw(x)))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 8)
    # the JAX form is a dense matmul over all n_in rows: float32 sums of
    # up to 32 terms against a 4-term blend
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool_matches_jax(rng, hw):
    x = rng.standard_normal((2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jconvs.max_pool_2x2(jnp.asarray(x)))
    got = nhwc(convs.max_pool_2x2(nchw(x)))
    np.testing.assert_array_equal(got, want)     # floor mode, exact
