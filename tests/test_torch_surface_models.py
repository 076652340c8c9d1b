"""The port's reference-surface modules against the JAX package's, on the
CPU: ``models/common.py::ConditionalNorm``, ``models/cunet.py::
DoubleConvDown`` and ``UpsampleBox`` (plain and ``use_pallas``), with JAX's
weights carried by the new converters of ``compat/torch_io.py``.  Eval and
train mode: outputs MAE < 1e-5, the updated running statistics to 1e-5;
converter round trips bit-exact; ``UpsampleBox(use_pallas=True)`` on the CPU
(K2's plain version) equal to plain bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.models import common as jax_common
from weather_unet_tpu.models import cunet as jax_cunet
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.kernels import upsample as k2
from weather_unet_tpu_torch.models import (
    ConditionalNorm, DoubleConvDown, UpsampleBox)

MAE_TOL = 1e-5
STATS_TOL = 1e-5
B, H, W, C, OUT, NCLS = 3, 16, 12, 8, 12, 5


def _with_random_stats(variables, rng):
    """JAX variables with random running statistics (and a random ``embed``
    table), so eval mode is not the identity and a transposed mean or
    variance shows."""
    out = jax.tree_util.tree_map(np.asarray, variables)
    for bn in out["batch_stats"].values():
        bn["mean"] = rng.standard_normal(bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    if "embed" in out.get("params", {}):
        out["params"]["embed"] = rng.standard_normal(
            out["params"]["embed"].shape).astype(np.float32)
    return out


CASES = {
    # name: (JAX module, port module factory, from_jax, to_jax, class ids?)
    "conditional_norm": (
        jax_common.ConditionalNorm(NCLS),
        lambda: ConditionalNorm(C, NCLS),
        torch_io.conditional_norm_state_dict_from_jax,
        torch_io.conditional_norm_state_dict_to_jax, True),
    "double_conv_down": (
        jax_cunet.DoubleConvDown(OUT),
        lambda: DoubleConvDown(C, OUT),
        torch_io.double_conv_down_state_dict_from_jax,
        torch_io.double_conv_down_state_dict_to_jax, False),
    "upsample_box": (
        jax_cunet.UpsampleBox(),
        lambda: UpsampleBox(C),
        torch_io.upsample_box_state_dict_from_jax,
        torch_io.upsample_box_state_dict_to_jax, False),
}


def _setup(name, seed=0):
    jmod, build, from_jax, to_jax, with_class = CASES[name]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, H, W, C)) * 1.5 + 0.5).astype(np.float32)
    cls = rng.integers(0, NCLS, B).astype(np.int32)
    jargs = (jnp.asarray(x),) + ((jnp.asarray(cls),) if with_class else ())
    variables = _with_random_stats(
        jmod.init(jax.random.key(seed), *jargs), rng)
    port = build()
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          from_jax(variables).items()}, strict=True)
    pargs = (nchw(x),) + ((torch.from_numpy(cls).long(),)
                          if with_class else ())
    return jmod, variables, port, jargs, pargs


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_module_matches_jax(name, train):
    jmod, variables, port, jargs, pargs = _setup(name)
    if train:
        want, upd = jmod.apply(variables, *jargs, train=True,
                               mutable=["batch_stats"])
    else:
        want, upd = jmod.apply(variables, *jargs, train=False), None
    with torch.no_grad():
        got = port(*pargs, train=train)
    mae = float(np.abs(nhwc(got) - np.asarray(want)).mean())
    assert mae < MAE_TOL, mae
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-4,
                               rtol=0)
    bn = port.bn
    stats = upd["batch_stats"]["bn"] if train else variables[
        "batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=STATS_TOL,
                               rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=STATS_TOL,
                               rtol=0)
    assert int(bn.num_batches_tracked) == int(train)


@pytest.mark.parametrize("name", sorted(CASES))
def test_converters_round_trip_bit_exact(name):
    """JAX -> port -> JAX and port -> JAX -> port give back every array bit
    for bit (``num_batches_tracked``, which JAX does not keep, comes back
    as 0)."""
    _, variables, port, _, _ = _setup(name, seed=1)
    _, _, from_jax, to_jax, _ = CASES[name]
    back = to_jax(from_jax(variables))
    flat = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat, flat_back):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    sd = port.state_dict()
    sd2 = from_jax(to_jax(sd))
    assert sd2.keys() == sd.keys()
    for k, v in sd.items():
        assert np.array_equal(np.asarray(sd2[k]), v.numpy()), k


def test_upsample_box_use_pallas_on_cpu_is_plain():
    """On a CPU tensor the use_pallas route is K2's plain version: equal
    bit for bit in both modes and dtypes, no kernel launch counted; the
    running statistics move alike."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, C, 9, 7)).astype(np.float32))
    before = k2.launches
    for dtype in (torch.float32, torch.bfloat16):
        for train in (False, True):
            plain, fused = UpsampleBox(C), UpsampleBox(C, use_pallas=True)
            fused.load_state_dict(plain.state_dict())
            a = plain(x.to(dtype), train=train)
            b = fused(x.to(dtype), train=train)
            assert a.dtype == dtype and torch.equal(a, b)
            assert torch.equal(plain.bn.running_var, fused.bn.running_var)
    assert k2.launches == before


def test_module_train_flag_and_seeded_init():
    """``train`` selects the BatchNorm mode per call, whatever
    ``module.training`` says; a generator seeds DoubleConvDown's convs."""
    x = torch.randn(2, C, 8, 8, generator=torch.Generator().manual_seed(3))
    m = ConditionalNorm(C, NCLS)
    cls = torch.tensor([0, 4])
    m.eval()
    m(x, cls, train=True)
    assert int(m.bn.num_batches_tracked) == 1
    m.train()
    y = m(x, cls)                        # train=False: running statistics
    assert int(m.bn.num_batches_tracked) == 1
    ref = m.bn(x, train=False)
    assert torch.equal(y, ref)           # class rows start at gamma 1, beta 0
    a = DoubleConvDown(C, OUT, generator=torch.Generator().manual_seed(4))
    b = DoubleConvDown(C, OUT, generator=torch.Generator().manual_seed(4))
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert a(x).shape == (2, OUT, 4, 4)
