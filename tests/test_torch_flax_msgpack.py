"""The port's flax msgpack reader and writer (``train/checkpoint.py``, no
flax) against flax's own ``msgpack_restore`` / ``to_bytes`` and the JAX
package's ``save_checkpoint_file``, and its serving loaders on JAX-package
msgpack checkpoints.  Trees: float32, bfloat16, int, scalar and nested
leaves, chunked leaves, and a real GAN training state.  Bars: bytes equal,
leaves bit-equal; a cUNet loaded from msgpack within MAE 1e-5 of JAX's
forward and bit-equal to the same weights from a ``.pt``; ResNet logits
within 2e-4 of JAX's."""

import collections

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization

from tests.test_torch_resnet import jax_resnet_variables
from tests.torch_port_util import (  # noqa: F401
    no_thread_left, one_torch_thread)
from weather_unet_tpu.models import ConditionalUNet as JaxUNet
from weather_unet_tpu.train import checkpoint as jax_ckpt
from weather_unet_tpu.train.gan import GanConfig, build_gan_state
from weather_unet_tpu_torch.cli.common import load_estimator, load_transfer
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.train import checkpoint as ckpt

SIZE = 32
Moments = collections.namedtuple("Moments", "mu nu")


def bf16_tensor(a) -> torch.Tensor:
    """A bfloat16 numpy array (ml_dtypes, from JAX) as a torch tensor."""
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
        torch.bfloat16)


def as_port(tree):
    """The same tree with JAX arrays as numpy arrays and bfloat16 leaves as
    torch.bfloat16 tensors (what the port reads, and writes from)."""
    if isinstance(tree, jax.Array):
        tree = np.asarray(tree)
    if isinstance(tree, dict):
        return {k: as_port(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(as_port(v) for v in tree)
    if isinstance(tree, tuple):
        return type(tree)(*(as_port(v) for v in tree))
    if isinstance(tree, (np.ndarray, np.generic)) and tree.dtype == jnp.bfloat16:
        return bf16_tensor(tree)
    return tree


def assert_same(got, want, where="tree"):
    """The port's restored tree equals flax's: same keys in the same order,
    leaves of the same type, dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (np.ndarray, np.generic)) and (
            want.dtype == jnp.bfloat16):
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        assert torch.equal(got, bf16_tensor(want)), where
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def tree_of(kind, rng):
    if kind == "float32":
        return {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                "b": rng.standard_normal(7).astype(np.float32)}
    if kind == "bfloat16":
        return {"k": np.asarray(jnp.asarray(rng.standard_normal((6, 5)),
                                            jnp.bfloat16)),
                "s": np.asarray(jnp.asarray(1.5, jnp.bfloat16))}
    if kind == "int":
        return {"i32": np.arange(12, dtype=np.int32).reshape(3, 4),
                "u8": rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
                "i64": np.array([-1, 2 ** 40], np.int64)}
    if kind == "scalar":
        return {"f": np.float32(0.25), "i": np.int64(7), "py_int": 3,
                "py_float": 2.5, "flag": True, "none": None, "name": "cunet",
                "c": 1 - 2j, "zero_d": np.array(4.0, np.float32)}
    if kind == "nested":
        return {"z": {"b": [np.ones((2, 2), np.float32), (3, np.int32(4))],
                      "a": Moments(np.zeros(3, np.float32), ())},
                "a": {"empty": {}, "x": np.arange(9, dtype=np.float64)}}
    if kind == "chunked":
        return {"big": np.arange(40, dtype=np.float32),
                "small": {"v": np.arange(3, dtype=np.int16)}}
    _, _, state = build_gan_state(GanConfig(input_size=SIZE),
                                  jax.random.key(0))
    return state                                     # kind == "gan"


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int", "scalar",
                                  "nested", "chunked", "gan"])
def test_reader_and_writer_match_flax(kind, rng, tmp_path, monkeypatch):
    if kind == "chunked":               # leaves over 64 bytes split
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
        monkeypatch.setattr(ckpt, "MAX_CHUNK_SIZE", 64)
    tree = tree_of(kind, rng)
    data = serialization.to_bytes(tree)
    if kind == "chunked":
        assert b"__msgpack_chunked_array__" in data
    restored = serialization.msgpack_restore(data)
    assert_same(ckpt.msgpack_restore(data), restored)
    # the writer: flax's bytes from the same tree, and from what was read
    state_dict = serialization.to_state_dict(tree)
    assert ckpt.to_bytes(as_port(state_dict)) == data
    assert ckpt.to_bytes(ckpt.msgpack_restore(data)) == data
    # a file as the JAX package writes it (host tree, keys sorted)
    if kind != "scalar":               # its _to_host turns a str into an array
        jax_ckpt.save_checkpoint_file(str(tmp_path / "jax.msgpack"),
                                      state_dict)
        ckpt.save_checkpoint_file(str(tmp_path / "port.msgpack"),
                                  as_port(state_dict))
        assert ((tmp_path / "port.msgpack").read_bytes()
                == (tmp_path / "jax.msgpack").read_bytes())
        assert_same(ckpt.restore_checkpoint(str(tmp_path / "jax.msgpack")),
                    jax_ckpt.restore_checkpoint(str(tmp_path / "jax.msgpack"),
                                                None))


@pytest.fixture(scope="module")
def unet():
    """A seeded JAX cUNet, a batch and JAX's forward on it."""
    _, _, state = build_gan_state(GanConfig(input_size=SIZE),
                                  jax.random.key(3))
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    want = np.asarray(JaxUNet(num_classes=5).apply(
        {"params": state.gen.params}, jnp.asarray(x), jnp.asarray(c)))
    return state, x, c, want


@pytest.mark.parametrize("layout", ["gan", "params"])
def test_load_transfer_from_msgpack_matches_jax(unet, layout, tmp_path):
    state, x, c, want = unet
    path = str(tmp_path / "ckpt_s0000000000.msgpack")
    if layout == "gan":                 # the trainer's file: the whole state
        jax_ckpt.save_checkpoint_file(path, state)
    else:
        jax_ckpt.save_checkpoint_file(path, {"params": state.gen.params})
    pt = str(tmp_path / "gan.pt")
    jax_ckpt.export_torch_gan(pt, {"params": state.gen.params},
                              {"params": state.disc.params,
                               "spectral": state.spectral}, 0, 0)
    for use_pallas in (False, "auto"):
        model = load_transfer(path, use_pallas=use_pallas, device="cpu")
        assert model.use_pallas is (use_pallas == "auto")
        with torch.no_grad():
            got = model(torch.from_numpy(x).permute(0, 3, 1, 2),
                        torch.from_numpy(c)).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - want).mean() < 1e-5
    # the same weights from the reference .pt, bit for bit
    from_pt = load_transfer(pt, device="cpu").state_dict()
    from_msgpack = model.state_dict()
    assert from_pt.keys() == from_msgpack.keys()
    for k, v in from_pt.items():
        assert torch.equal(v, from_msgpack[k]), k


def test_load_estimator_from_msgpack_matches_jax(rng, tmp_path):
    model, variables = jax_resnet_variables(counts=(1, 1, 1, 1),
                                            num_classes=5, size=SIZE)
    x = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    # the JAX supervised loop's layout (train/loops.py::train_supervised)
    path = jax_ckpt.save_checkpoint(
        str(tmp_path), "est", 3,
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"], "opt_state": {},
         "epoch": 1, "global_step": 3, "epoch_step": 0})
    apply = load_estimator(path, device="cpu")
    assert apply.model.block_counts == (1, 1, 1, 1)
    np.testing.assert_allclose(apply(x).numpy(), want, atol=2e-4)
    pt = str(tmp_path / "est.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                torch_io.resnet_state_dict_from_jax(variables).items()}, pt)
    from_pt = load_estimator(pt, device="cpu").model.state_dict()
    for k, v in apply.model.state_dict().items():
        assert torch.equal(v, from_pt[k]), k


def test_msgpack_errors(unet, tmp_path):
    state, *_ = unet
    path = str(tmp_path / "g.msgpack")
    jax_ckpt.save_checkpoint_file(path, {"gen": {"params": state.gen.params}})
    # JAX's class-count check and message
    with pytest.raises(ValueError, match="5 condition.*num_classes=6"):
        load_transfer(path, num_classes=6, device="cpu")
    from weather_unet_tpu.cli.common import load_transfer as jax_load

    with pytest.raises(ValueError, match="5 condition.*num_classes=6"):
        jax_load(path, num_classes=6)
    other = str(tmp_path / "other.msgpack")
    jax_ckpt.save_checkpoint_file(other, {"weights": np.zeros(3)})
    with pytest.raises(ValueError, match="unrecognized checkpoint layout"):
        load_transfer(other, device="cpu")
    with pytest.raises(ValueError, match="'params' and 'batch_stats'"):
        load_estimator(other, device="cpu")
    garbage = tmp_path / "garbage.ckpt"
    garbage.write_bytes(b"\xc1 not msgpack")
    with pytest.raises(ValueError, match="not a flax msgpack checkpoint"):
        load_transfer(str(garbage), device="cpu")
    # resuming a JAX training run is not ported: it says where it stands
    from weather_unet_tpu_torch.core.state import GanTrainState

    with pytest.raises(NotImplementedError, match="JAX training state"):
        ckpt.restore_checkpoint(path, GanTrainState.__new__(GanTrainState))
    assert list(ckpt.restore_checkpoint(path)) == ["gen"]
