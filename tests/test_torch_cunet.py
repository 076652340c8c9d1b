"""The port's ConditionalUNet against the JAX package's, on the CPU: JAX
weights carried across by the port's converter, the same numpy inputs, in
the plain, use_pallas (K1) and fuse_upconv (K3) configurations.  The bar is
tests/test_model_parity.py's: f32 pixel MAE < 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import one_torch_thread  # noqa: F401
from weather_unet_tpu.compat import torch_io as jax_torch_io
from weather_unet_tpu.models import ConditionalUNet as JaxUNet
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ConditionalUNet


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    model = JaxUNet(num_classes=5)
    variables = model.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(c))
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x),
                                           jnp.asarray(c)))
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in torch_io.cunet_state_dict_from_jax(variables).items()}
    return variables, sd, x, c, want


def port_forward(model, x, c):
    with torch.no_grad():
        y = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                  torch.from_numpy(c))
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("config", [{}, {"use_pallas": True},
                                    {"fuse_upconv": True},
                                    {"fuse_upconv": (1, 3)}],
                         ids=["plain", "use_pallas", "fuse_upconv",
                              "fuse_levels_1_3"])
def test_cunet_matches_jax(setup, config):
    _, sd, x, c, want = setup
    model = ConditionalUNet(5, **config).eval()
    model.load_state_dict(sd, strict=True)
    got = port_forward(model, x, c)
    assert got.shape == want.shape == (2, 32, 32, 3)
    mae = float(np.abs(got - want).mean())
    assert mae < 1e-5, f"pixel MAE {mae}"
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_state_dict_names_are_the_reference_ones(setup):
    variables, sd, _, _, _ = setup
    ref = jax_torch_io.cunet_to_torch(variables)
    model = ConditionalUNet(5)
    assert set(model.state_dict()) == set(ref) == set(sd)
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == ref[k].shape, k
    # a state dict made by the JAX package's own exporter loads strictly
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in ref.items()}, strict=True)


def test_converter_round_trip(setup):
    variables, sd, _, _, _ = setup
    back = torch_io.cunet_state_dict_to_jax(sd)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


def test_bf16_holds_to_own_f32(setup):
    _, sd, x, c, _ = setup
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        model = ConditionalUNet(5, dtype=dt, fuse_upconv=(2,)).eval()
        model.load_state_dict(sd, strict=True)
        outs.append(port_forward(model, x, c))
    assert float(np.abs(outs[0] - outs[1]).mean()) <= 1e-3   # BASELINE.json


def test_train_mode_and_bad_fused_conv_raise(setup):
    _, sd, x, c, _ = setup
    model = ConditionalUNet(5)
    # train mode draws dropout masks, so it needs a generator for them
    with pytest.raises(ValueError, match="generator"):
        model(torch.zeros(1, 3, 8, 8), torch.zeros(1, 5), train=True)
    with pytest.raises(ValueError, match="3x3"):
        model.conv_last(torch.zeros(1, 32, 4, 4), torch.zeros(1, 32, 8, 8),
                        fused_upsample=True)
