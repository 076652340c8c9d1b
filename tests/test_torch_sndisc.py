"""The port's spectral normalization and SNDisc against the JAX package's, on
the CPU: JAX variables carried across by the port's
``sndisc_state_dict_from_jax``, the same numpy inputs.  Tolerances: 1e-6 on
the power iteration (float32, one matrix-vector product each way), 1e-5 on
the discriminator's outputs, feature maps and updated ``u`` (float32 convs),
relative 1e-4 on weight gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import nchw, nhwc, one_torch_thread  # noqa: F401
from weather_unet_tpu.compat import torch_io as jax_torch_io
from weather_unet_tpu.models import SNDisc as JaxSNDisc
from weather_unet_tpu.ops import spectral as jax_spectral
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.models.sndisc import SNDisc
from weather_unet_tpu_torch.ops import spectral

SIZE = 16


def as_tensors(sd):
    return {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    c = rng.standard_normal((2, 5)).astype(np.float32)
    model = JaxSNDisc(num_classes=5)
    variables = model.init(jax.random.key(2), jnp.asarray(x), jnp.asarray(c))
    variables = jax.tree.map(np.asarray, dict(variables))
    port = SNDisc(5)
    port.load_state_dict(as_tensors(
        torch_io.sndisc_state_dict_from_jax(variables)), strict=True)
    return model, variables, port, x, c


def u_tree(port):
    """A copy of the port's u buffers as the JAX 'spectral' collection."""
    return torch_io.sndisc_state_dict_to_jax(
        {k: v.clone() for k, v in port.state_dict().items()})["spectral"]


@pytest.mark.parametrize("kind", ["conv", "dense"])
@pytest.mark.parametrize("update", [False, True], ids=["read", "update"])
def test_spectral_normalize_matches_jax(rng, kind, update):
    if kind == "conv":      # HWIO in JAX, OIHW in the port
        k = rng.standard_normal((3, 3, 6, 10)).astype(np.float32)
        w = np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1)))
        w_mat_jax = np.transpose(k, (3, 0, 1, 2)).reshape(10, -1)
    else:                   # (in, out) in JAX, (out, in) in the port
        k = rng.standard_normal((7, 10)).astype(np.float32)
        w = np.ascontiguousarray(k.T)
        w_mat_jax = k.T
    u = rng.standard_normal(10).astype(np.float32)
    u /= np.linalg.norm(u)
    want_w, want_u = jax_spectral.spectral_normalize(
        jnp.asarray(k), jnp.asarray(u), update=update)
    want_sigma, _ = jax_spectral.power_iteration(
        jnp.asarray(w_mat_jax), jnp.asarray(u), update=update)
    u_t = torch.from_numpy(u.copy())
    got_w, got_u, _ = spectral.spectral_normalize(torch.from_numpy(w), u_t,
                                                  update)
    sigma, _, _ = spectral.power_iteration(
        spectral.weight_matrix(torch.from_numpy(w)), u_t, update)
    want_w = np.asarray(want_w)
    if kind == "conv":
        want_w = np.transpose(want_w, (3, 2, 0, 1))
    else:
        want_w = want_w.T
    np.testing.assert_allclose(got_w.numpy(), want_w, atol=1e-6)
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), atol=1e-6)
    np.testing.assert_allclose(float(sigma), float(want_sigma), rtol=1e-6)
    assert np.array_equal(u_t.numpy(), u)       # the argument is not touched
    if not update:
        np.testing.assert_array_equal(got_u.numpy(), u)


@pytest.mark.parametrize("update", [False, True], ids=["eval", "update"])
def test_sndisc_forward_matches_jax(setup, update):
    model, variables, _, x, c = setup
    port = SNDisc(5)
    port.load_state_dict(as_tensors(
        torch_io.sndisc_state_dict_from_jax(variables)), strict=True)
    (want, want_feats), mutated = model.apply(
        variables, jnp.asarray(x), jnp.asarray(c), update_stats=update,
        mutable=["spectral"])
    u_before = u_tree(port)
    with torch.no_grad():
        got, feats = port(nchw(x), torch.from_numpy(c), update_stats=update)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert len(feats) == 4
    for f, wf in zip(feats, want_feats):
        np.testing.assert_allclose(nhwc(f), np.asarray(wf), atol=1e-5)
    want_u = mutated["spectral"] if update else variables["spectral"]
    got_u = u_tree(port)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                         atol=1e-5),
                 got_u, dict(want_u))
    # a u of one element (the 512 -> 1 head) is +-1 and stays where it is
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: bool(np.any(a != b)) if a.size > 1 else None, got_u,
        u_before))
    assert len(moved) == 9
    assert all(moved) if update else not any(moved)


def test_sndisc_weight_grads_match_jax(setup):
    model, variables, port, x, c = setup

    def loss(params):
        out, _ = model.apply({"params": params,
                              "spectral": variables["spectral"]},
                             jnp.asarray(x), jnp.asarray(c))
        return jnp.sum(out)

    grads = jax.grad(loss)(jax.tree.map(jnp.asarray, variables["params"]))
    want = torch_io.sndisc_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads),
         "spectral": variables["spectral"]})
    port.zero_grad()
    out, _ = port(nchw(x), torch.from_numpy(c))
    out.sum().backward()
    names = [n for n, _ in port.named_parameters() if n.endswith(
        "weight_orig")]
    assert len(names) == 10
    for name, p in port.named_parameters():
        if name.endswith("weight_orig"):
            scale = max(1.0, float(np.abs(want[name]).max()))
            err = float(np.abs(p.grad.numpy() - want[name]).max()) / scale
            assert err <= 1e-4, (name, err)


def test_sndisc_state_dict_round_trip_and_reference_load(setup):
    _, variables, port, _, _ = setup
    sd = torch_io.sndisc_state_dict_from_jax(variables)
    assert set(sd) == set(port.state_dict())
    back = torch_io.sndisc_state_dict_to_jax(as_tensors(sd))
    jax.tree.map(np.testing.assert_array_equal, back,
                 {"params": variables["params"],
                  "spectral": variables["spectral"]})
    # the JAX package's sndisc_to_torch also writes the normalized 'weight';
    # a strict load drops it, as torch's own spectral-norm load hook does
    ref = jax_torch_io.sndisc_to_torch(variables)
    assert set(ref) - set(sd) == {k[:-len("_orig")] for k in sd
                                  if k.endswith("weight_orig")}
    other = SNDisc(5, generator=torch.Generator().manual_seed(9))
    other.load_state_dict(as_tensors(ref), strict=True)
    for k, v in other.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # seeded init: the same seed gives the same discriminator
    a = SNDisc(5, generator=torch.Generator().manual_seed(4)).state_dict()
    b = SNDisc(5, generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
