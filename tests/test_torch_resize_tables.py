"""The numpy interpolation tables of weather_unet_tpu_torch.ops.resize: equal
to the JAX package's, and describing one interpolation (the 2-tap tables the
K3 kernel reads, the dense matrix, the even/odd phase weights)."""

import numpy as np
import pytest

from tests.torch_port_util import no_thread_left  # noqa: F401
from weather_unet_tpu.ops import resize as jresize
from weather_unet_tpu_torch.ops import resize


@pytest.mark.parametrize("n", [1, 2, 7, 128])
def test_resize_tables_match_jax(n):
    for a, b in zip(resize._x2_taps(n), jresize._x2_taps(n)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(resize._x2_shift_weights(n), jresize._x2_shift_weights(n)):
        np.testing.assert_array_equal(a, b)
    for ac in (True, False):
        np.testing.assert_array_equal(resize._interp_matrix_np(2 * n, n, ac),
                                      jresize._interp_matrix_np(2 * n, n, ac))


@pytest.mark.parametrize("n", [1, 2, 5, 32])
def test_x2_taps_are_the_interp_matrix_and_the_phase_weights(n):
    """The kernel's 2-tap tables, the dense matrix and the even/odd phase
    weights describe one interpolation."""
    i0, i1, f = resize._x2_taps(n)
    dense = np.zeros((2 * n, n), np.float32)
    np.add.at(dense, (np.arange(2 * n), i0), 1.0 - f)
    np.add.at(dense, (np.arange(2 * n), i1), f)
    np.testing.assert_allclose(dense, resize._interp_matrix_np(2 * n, n),
                               atol=1e-7)
    # even output 2m weighs x[m-1] by a[m]; odd output 2m+1 weighs x[m+1]
    # by b[m]; both are 0 where the neighbour is off the edge
    a, b = resize._x2_shift_weights(n)
    m = np.arange(n)
    prev_w = np.where(m > 0, dense[2 * m, np.maximum(m - 1, 0)], 0.0)
    next_w = np.where(m < n - 1, dense[2 * m + 1, np.minimum(m + 1, n - 1)],
                      0.0)
    np.testing.assert_allclose(prev_w, a, atol=1e-6)
    np.testing.assert_allclose(next_w, b, atol=1e-6)
