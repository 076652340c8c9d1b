"""The port's estimator entry point and transfer-consistency evaluation on the
CPU against the JAX package's: ``cli.common.load_estimator`` on a saved state
dict, and the four compute functions of ``evaluation/transfer.py`` over a
tiny cUNet and a (2, 1, 1, 1) ResNet with the weights carried across.
Tolerances: 2e-4 on logits, labels equal, rows within 1e-4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_resnet import jax_resnet_variables
from tests.torch_port_util import one_torch_thread  # noqa: F401
from weather_unet_tpu.evaluation import transfer as jax_transfer
from weather_unet_tpu.models import ConditionalUNet as JaxUNet
from weather_unet_tpu_torch.api import WeatherTransfer
from weather_unet_tpu_torch.cli.common import load_estimator
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.evaluation import transfer
from weather_unet_tpu_torch.models import ConditionalUNet, ResNet

SIZE = 16


def as_tensors(sd):
    return {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}


@pytest.fixture(scope="module")
def estimator(tmp_path_factory):
    """A 5-output (2, 1, 1, 1) ResNet: the JAX apply, and the port's apply
    loaded from a state-dict .pt."""
    model, variables = jax_resnet_variables(num_classes=5, size=SIZE, seed=5)
    path = str(tmp_path_factory.mktemp("est") / "estimator.pt")
    sd = as_tensors(torch_io.resnet_state_dict_from_jax(variables))
    torch.save({f"module.{k}": v for k, v in sd.items()}, path)
    jax_apply = jax.jit(lambda x: model.apply(variables, x, train=False))
    return path, jax_apply, load_estimator(path, device="cpu")


@pytest.fixture(scope="module")
def transfers():
    rng = np.random.default_rng(6)
    model = JaxUNet(num_classes=5)
    variables = model.init(jax.random.key(1), jnp.zeros((1, SIZE, SIZE, 3)),
                           jnp.zeros((1, 5)))
    port = ConditionalUNet(5)
    port.load_state_dict(as_tensors(
        torch_io.cunet_state_dict_from_jax(variables)), strict=True)
    batches = [rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
               for _ in range(2)]
    conds = [rng.standard_normal((3, 5)).astype(np.float32) for _ in range(2)]
    return (model, variables, WeatherTransfer(port, device="cpu"), batches,
            conds)


@pytest.mark.parametrize("softmax", [False, True], ids=["logits", "softmax"])
def test_load_estimator_matches_jax(estimator, rng, softmax):
    path, jax_apply, _ = estimator
    x = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    want = jax_apply(jnp.asarray(x))
    if softmax:
        want = jax.nn.softmax(want, axis=1)
    apply = load_estimator(path, softmax=softmax, device="cpu")
    assert isinstance(apply.model, ResNet) and not apply.model.training
    assert apply.model.block_counts == (2, 1, 1, 1)      # read from the keys
    got = apply(x)                                       # NHWC numpy in
    assert got.shape == (3, 5) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_array_equal(apply(torch.from_numpy(x)).numpy(),
                                  got.numpy())
    if softmax:
        np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)


def test_load_estimator_errors(estimator, tmp_path, monkeypatch):
    path, _, apply = estimator
    with pytest.raises(ValueError, match="msgpack"):
        load_estimator(str(tmp_path / "ckpt"), device="cpu")
    with pytest.raises(ValueError, match="num_classes=5"):
        load_estimator(path, num_classes=6, device="cpu")
    # a whole-model pickle (the reference's estimator format) is refused
    # with the conversion hint, and so is a file that holds no ResNet
    pickled = str(tmp_path / "whole_model.pt")
    torch.save(apply.model, pickled)
    with pytest.raises(ValueError, match="state_dict"):
        load_estimator(pickled, device="cpu")
    other = str(tmp_path / "other.pt")
    torch.save({"inference": {}}, other)
    with pytest.raises(ValueError, match="not a state dict"):
        load_estimator(other, device="cpu")
    # no GPU and no device given: raise, never fall back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_estimator(path)


def test_class_transfer_consistency_matches_jax(estimator, transfers):
    _, jax_apply, apply = estimator
    model, variables, wt, batches, _ = transfers
    want_true, want_pred = jax_transfer.class_transfer_consistency(
        model, variables, jax_apply, [jnp.asarray(b) for b in batches])
    seen = []

    def classify(images):
        seen.append(tuple(images.shape))
        return apply(images)

    y_true, y_pred = transfer.class_transfer_consistency(wt, classify, batches)
    assert seen == [(15, SIZE, SIZE, 3)] * 2         # all classes in one call
    assert y_true.shape == y_pred.shape == (30,)
    np.testing.assert_array_equal(y_true, want_true)
    np.testing.assert_array_equal(y_pred, want_pred)
    with pytest.raises(ValueError, match="num_classes"):
        transfer.class_transfer_consistency(wt, classify, batches,
                                            num_classes=6)


def test_estimator_transfer_consistency_matches_jax(estimator, transfers):
    _, jax_apply, apply = estimator
    model, variables, wt, batches, conds = transfers
    sigma = np.arange(1.0, 6.0, dtype=np.float32)
    want = jax_transfer.estimator_transfer_consistency(
        model, variables, jax_apply,
        [(jnp.asarray(b), jnp.asarray(c)) for b, c in zip(batches, conds)],
        sigma=sigma)
    sizes = []

    def estimate(images):
        sizes.append(images.shape[0])
        return apply(images)

    got = transfer.estimator_transfer_consistency(
        wt, estimate, list(zip(batches, conds)), sigma=sigma)
    # one reference condition at a time: B forwards of B images a batch
    assert sizes == [3] * 6
    assert got["rows"].shape == (6, 5) and set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=1e-4,
                                   err_msg=key)
    assert "signed_mean_denorm" not in transfer.estimator_transfer_consistency(
        wt, estimate, [(batches[0][:1], conds[0][:1])])


def test_classifier_accuracy_matches_jax(estimator, transfers):
    _, jax_apply, apply = estimator
    _, _, _, batches, _ = transfers
    labeled = [(batches[0], np.array([0, 3, 1])),
               (batches[1], np.array([4.0, 4.0, 2.0]), ["a", "b", "c"])]
    want = jax_transfer.classifier_accuracy(
        jax_apply, [(jnp.asarray(b[0]),) + b[1:] for b in labeled])
    got = transfer.classifier_accuracy(apply, labeled)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2] == ["a", "b", "c"]
    assert transfer.classifier_accuracy(apply, labeled[:1])[2] == []


def test_estimator_errors_matches_jax(estimator, transfers):
    _, jax_apply, apply = estimator
    _, _, _, batches, conds = transfers
    sigma = np.arange(1.0, 6.0, dtype=np.float32)
    want = jax_transfer.estimator_errors(
        jax_apply, [(jnp.asarray(b), c) for b, c in zip(batches, conds)],
        sigma=sigma)
    got = transfer.estimator_errors(
        apply, [(b, torch.from_numpy(c)) for b, c in zip(batches, conds)],
        sigma=sigma)
    assert set(got) == set(want) and got["signed_l1"].shape == (6, 5)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=2e-4,
                                   err_msg=key)
