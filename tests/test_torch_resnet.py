"""The port's BatchNorm2d and ResNet against the JAX package's, on the CPU:
JAX variables carried across by the port's ``resnet_state_dict_from_jax``,
the same numpy inputs, eval and train mode.  Tolerances: 1e-5 on BatchNorm
outputs and running statistics (float32, one normalization), 2e-4 on logits
(the bar of tests/test_kernels.py for a whole small ResNet)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.compat import torch_io as jax_torch_io
from weather_unet_tpu.models import ResNet as JaxResNet
from weather_unet_tpu.models.common import BatchNorm2d as JaxBatchNorm2d
from weather_unet_tpu.ops import convs as jax_convs
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models import ResNet, ResNet50
from weather_unet_tpu_torch.models.common import BatchNorm2d
from weather_unet_tpu_torch.ops.convs import max_pool

COUNTS = (2, 1, 1, 1)


def jax_resnet_variables(counts=COUNTS, num_classes=7, size=32, seed=1):
    """A JAX ResNet and its variables as numpy trees, with every BatchNorm's
    scale, bias and running statistics drawn at random (scale in [0.5, 1.5),
    variance in [0.5, 2), bias and mean N(0, 0.1)), so that folding and the
    converters are exercised and the ReLUs stay alive."""
    model = JaxResNet(block_counts=counts, num_classes=num_classes)
    v = model.init(jax.random.key(0), jnp.zeros((1, size, size, 3)),
                   train=False)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        keys = [p.key for p in path]
        shape = leaf.shape
        if "bn" in keys[-2]:
            if keys[-1] == "scale":
                return rng.uniform(0.5, 1.5, shape).astype(np.float32)
            if keys[-1] == "var":
                return rng.uniform(0.5, 2.0, shape).astype(np.float32)
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return np.asarray(leaf)

    return model, jax.tree_util.tree_map_with_path(draw, dict(v))


def port_resnet(variables, counts=COUNTS, num_classes=7, **kw):
    """The port's ResNet with the JAX variables loaded strictly."""
    model = ResNet(counts, num_classes, **kw)
    sd = torch_io.resnet_state_dict_from_jax(variables)
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module")
def setup():
    model, variables = jax_resnet_variables()
    x = np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(
        np.float32)
    return model, variables, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_matches_jax(rng, train):
    x = (3.0 * rng.standard_normal((3, 5, 7, 6)) + 1.5).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                   "bias": rng.standard_normal(6).astype(np.float32)},
        "batch_stats": {"mean": rng.standard_normal(6).astype(np.float32),
                        "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
    want, updated = JaxBatchNorm2d().apply(
        variables, jnp.asarray(x), use_running_average=not train,
        mutable=["batch_stats"])
    bn = BatchNorm2d(6)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
        "num_batches_tracked": torch.tensor(0)}, strict=True)
    bn.train(train)
    with torch.no_grad():
        got = bn(nchw(x))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    stats = updated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5)
    assert int(bn.num_batches_tracked) == int(train)
    if train:      # the running variance takes the UNBIASED batch variance
        n = 3 * 5 * 7
        biased = x.reshape(-1, 6).var(axis=0)
        np.testing.assert_allclose(
            bn.running_var.numpy(),
            0.9 * variables["batch_stats"]["var"] + 0.1 * biased * n / (n - 1),
            atol=1e-5)


def test_batchnorm_keeps_statistics_in_float32_for_bf16(rng):
    x = nchw((2.0 * rng.standard_normal((2, 4, 4, 3)) + 100.0).astype(
        np.float32))
    bn = BatchNorm2d(3).train()
    with torch.no_grad():
        got = bn(x.bfloat16())
        want = BatchNorm2d(3).train()(x.bfloat16().float())
    assert got.dtype == torch.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    # a one-pass or bf16 variance would be far off at mean 100
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * x.bfloat16().float().var((0, 2, 3)),
                               rtol=1e-5)
    assert BatchNorm2d(3, affine=False).weight is None


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_matches_jax(setup, train):
    jax_model, variables, x = setup
    want, updated = jax_model.apply(variables, jnp.asarray(x), train=train,
                                    mutable=["batch_stats"])
    model = port_resnet(variables).train(train)
    with torch.no_grad():
        got = model(nchw(x))
    assert got.shape == (4, 7) and got.dtype == torch.float32
    assert float(got.std()) > 1e-3                   # the ReLUs are alive
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    # the running statistics after the forward (unchanged in eval mode)
    back = torch_io.resnet_state_dict_to_jax(model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            updated["batch_stats"]):
        node = back["batch_stats"]
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, np.asarray(leaf), atol=2e-4,
                                   err_msg=str(path))
    with torch.no_grad():
        feats = model.eval()(nchw(x), features_only=True)
    assert feats.shape == (4, 2048)


def test_resnet_state_dict_round_trip_and_reference_names(setup):
    _, variables, _ = setup
    sd = torch_io.resnet_state_dict_from_jax(variables)
    ref = jax_torch_io.resnet_to_torch(variables)    # the JAX package's own
    assert set(sd) == set(ref) == set(ResNet(COUNTS, 7).state_dict())
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    # exact round trip, with the DataParallel prefix stripped and the depth
    # inferred from the key names
    back = torch_io.resnet_state_dict_to_jax(
        {f"module.{k}": a for k, a in sd.items()})
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))
    assert torch_io._infer_block_counts(sd.keys(), ".") == COUNTS
    assert torch_io._infer_block_counts(variables["params"].keys(),
                                        "_") == COUNTS
    # a state dict made by the JAX package's exporter loads strictly
    ResNet(COUNTS, 7).load_state_dict(
        {k: torch.from_numpy(np.array(a)) for k, a in ref.items()},
        strict=True)


def test_max_pool_matches_jax(rng):
    x = rng.standard_normal((2, 9, 11, 4)).astype(np.float32) - 3.0
    for window, stride, padding in ((3, 2, 1), (2, 2, 0), (3, 1, 1)):
        want = jax_convs.max_pool(jnp.asarray(x), window, stride, padding)
        got = max_pool(nchw(x), window, stride, padding)
        # all-negative input: a zero padding would show at the border
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_resnet_init_layout_and_dtype():
    a = ResNet(COUNTS, 5, generator=torch.Generator().manual_seed(3))
    b = ResNet(COUNTS, 5, generator=torch.Generator().manual_seed(3))
    c = ResNet(COUNTS, 5, generator=torch.Generator().manual_seed(4))
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("conv2.weight") or k == "fc.weight":
            assert not torch.equal(va, vc), k
    # kaiming_normal_(fan_out, relu): std = sqrt(2 / (O * kh * kw))
    w = a.layer3[0].conv2.weight.detach()
    assert w.shape == (256, 256, 3, 3) and a.layer3[0].conv2.stride == (2, 2)
    assert abs(float(w.std()) / (2.0 / (256 * 9)) ** 0.5 - 1.0) < 0.02
    assert a.layer1[0].downsample is not None and a.layer1[1].downsample is None
    assert a.layer1[0].conv2.stride == (1, 1) and a.conv1.bias is None
    assert ResNet50().block_counts == (3, 4, 6, 3)
    # bf16: conv and fc weights in bf16, BatchNorm parameters in float32
    h = ResNet(COUNTS, 5, dtype=torch.bfloat16).eval()
    assert h.conv1.weight.dtype == h.fc.weight.dtype == torch.bfloat16
    assert h.bn1.weight.dtype == h.bn1.running_var.dtype == torch.float32
    with torch.no_grad():
        assert h(torch.zeros(1, 3, 32, 32)).dtype == torch.bfloat16
