"""The port's FID Inception-v3 (``models/inception_fid.py``), its converters
(``compat/torch_io.py``), FID and IS math (``evaluation/fid.py``,
``evaluation/inception_score.py``), the weight checks and the goldens
registry on the CPU, against the JAX package's, on the same weights.

The weights are seeded random ones with BatchNorm calibrated on one batch
(``calibrate_batchnorm``): at its initial statistics a random Inception-v3
moves its activations far from unit scale, and a comparison of near-zero
or huge features says little.

Tolerances: the pool3 features and logits at a 128x128 input within the
JAX package's own bar against its torch mirror (``tests/test_eval.py:180``:
atol 2e-3, rtol 1e-3).  They cannot be much tighter there: the input resize
differs by up to 6.4e-6 between ``F.interpolate``'s float32 taps (the
port's and pytorch-fid's) and the JAX package's exact ones, and the
calibrated network amplifies it to a relative L2 error of ~4e-4.  At a
299x299 input (no resize) the network alone is held to a relative L2 error
of 1e-4 (float32 summation order, amplified the same way: 4.5e-5 seen) and
the resize alone to 1e-5.  FID and IS math: 1e-10 relative (the same
float64 numpy and scipy calls)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, no_thread_left, one_torch_thread)
from weather_unet_tpu.evaluation import fid as jax_fid
from weather_unet_tpu.evaluation import goldens as jax_goldens
from weather_unet_tpu.evaluation import inception_score as jax_is
from weather_unet_tpu.models import inception_fid as jax_inc
from weather_unet_tpu.ops.resize import resize_bilinear_torch as jax_resize
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.evaluation import fid, goldens, inception_score
from weather_unet_tpu_torch.models.inception_fid import (
    InceptionV3FID, avg_pool_3x3_s1, calibrate_batchnorm)
from weather_unet_tpu_torch.ops.resize import resize_bilinear_torch


def port_inception(seed=0, size=128, calib=4, **kw):
    """A seeded port Inception-v3 (``kw``: its head and variant) with
    BatchNorm calibrated on ``calib`` seeded [0, 1] images of ``size``."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionV3FID(generator=gen, **kw)
    x = torch.rand(calib, 3, size, size, generator=gen)
    return calibrate_batchnorm(model, x)


def state_dict_np(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def jax_variables(model):
    """The port model's weights as JAX ``InceptionV3FID`` variables."""
    return jax.tree.map(jnp.asarray, torch_io.inception_state_dict_to_jax(
        state_dict_np(model)))


def test_converters_round_trip_and_load_reference_layouts():
    port = port_inception(with_logits=True)
    variables = torch_io.inception_state_dict_to_jax(state_dict_np(port))
    # the tree JAX's InceptionV3FID defines, leaf for leaf and shape for shape
    expected = jax.eval_shape(lambda: jax_inc.InceptionV3FID(
        with_logits=True).init(jax.random.key(0), jnp.zeros((1, 75, 75, 3))))
    got_shapes = jax.tree.map(np.shape, variables)
    assert got_shapes == jax.tree.map(lambda s: s.shape, expected)
    back = torch_io.inception_state_dict_from_jax(variables)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    for k, v in sd.items():     # JAX keeps no num_batches_tracked: 0 back
        want = 0 if k.endswith("num_batches_tracked") else v.numpy()
        np.testing.assert_array_equal(back[k], want, err_msg=k)
    # the JAX package's converters agree with the port's
    from weather_unet_tpu.compat import torch_io as jax_io

    jax_sd = jax_io.inception_to_torch(variables)
    assert set(jax_sd) == {k for k in sd if "num_batches_tracked" not in k}
    for k, v in jax_sd.items():
        np.testing.assert_array_equal(np.asarray(v), sd[k].numpy(), err_msg=k)
    jax_back = jax_io.inception_from_torch(sd)
    assert jax.tree.map(np.shape, jax_back) == got_shapes

    # a torchvision file (AuxLogits, 1000-way fc, no num_batches_tracked)
    # and a pool3-only FID model from a file with a head load strictly
    stock = port_inception(with_logits=True, num_logits=1000,
                           tf_variant=False, calib=2, size=75)
    tv = {k: v for k, v in stock.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    tv["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    tv["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    InceptionV3FID(with_logits=True, num_logits=1000, tf_variant=False
                   ).load_state_dict(torch_io.inception_state_dict(
                       tv, with_logits=True))
    assert "AuxLogits" not in torch_io.inception_state_dict_to_jax(
        tv)["params"]
    InceptionV3FID().load_state_dict(torch_io.inception_state_dict(
        port.state_dict(), with_logits=False))


@pytest.mark.parametrize("head", ["pool3", "logits"])
def test_forward_matches_jax(head, rng):
    """pool3 features (the FID graph), then the 1008-way logits of the FID
    graph and the 1000-way logits of stock torchvision (the IS graph)."""
    x = rng.uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    if head == "pool3":
        port = port_inception()
        with torch.no_grad():
            out = port(nchw(x)).numpy()
        want = np.asarray(jax_inc.InceptionV3FID().apply(
            jax_variables(port), jnp.asarray(x)))
        assert out.shape == want.shape == (2, 2048)
        np.testing.assert_allclose(out, want, atol=2e-3, rtol=1e-3)
        # the network alone, without the resize, and the resize alone
        x299 = rng.uniform(0, 1, (2, 299, 299, 3)).astype(np.float32)
        port = port_inception(seed=1, size=299, calib=2)
        with torch.no_grad():
            out = port(nchw(x299)).numpy()
        want = np.asarray(jax_inc.InceptionV3FID().apply(
            jax_variables(port), jnp.asarray(x299)))
        assert (np.linalg.norm(out - want) / np.linalg.norm(want)) <= 1e-4
        got = resize_bilinear_torch(nchw(x), 299, 299, align_corners=False)
        np.testing.assert_allclose(
            got.permute(0, 2, 3, 1).numpy(),
            np.asarray(jax_resize(jnp.asarray(x), 299, 299,
                                  align_corners=False)), atol=1e-5)
        return
    for kw in (dict(num_logits=1008), dict(num_logits=1000,
                                           tf_variant=False)):
        port = port_inception(with_logits=True, **kw)
        with torch.no_grad():
            out = port(nchw(x)).numpy()
        want = np.asarray(jax_inc.InceptionV3FID(with_logits=True, **kw).apply(
            jax_variables(port), jnp.asarray(x)))
        assert out.shape == want.shape == (2, kw["num_logits"])
        np.testing.assert_allclose(out, want, atol=2e-3, rtol=1e-3)


def test_avg_pool_3x3_s1_both_ways(rng):
    x = rng.standard_normal((2, 9, 7, 4)).astype(np.float32)
    for include in (False, True):
        got = avg_pool_3x3_s1(nchw(x), include).permute(0, 2, 3, 1).numpy()
        want = np.asarray(jax_inc.avg_pool_3x3_s1(jnp.asarray(x), include))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the corner of a TF-variant pool averages 4 values, stock torchvision 9
    corner = x[:, :2, :2].sum(axis=(1, 2))
    np.testing.assert_allclose(avg_pool_3x3_s1(nchw(x), False)[:, :, 0, 0],
                               corner / 4, rtol=1e-6)
    np.testing.assert_allclose(avg_pool_3x3_s1(nchw(x), True)[:, :, 0, 0],
                               corner / 9, rtol=1e-6)


def test_fid_and_is_math_match_jax(rng):
    a = rng.standard_normal((40, 12)) * rng.uniform(0.5, 2, 12)
    b = rng.standard_normal((40, 12)) + 0.3
    for got, want in zip(fid.compute_statistics(a),
                         jax_fid.compute_statistics(a)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    m1, s1 = fid.compute_statistics(a)
    m2, s2 = fid.compute_statistics(b)
    assert fid.frechet_distance(m1, s1, m2, s2) == pytest.approx(
        jax_fid.frechet_distance(m1, s1, m2, s2), rel=1e-10)
    assert fid.fid_from_activations(a, b) == pytest.approx(
        jax_fid.fid_from_activations(a, b), rel=1e-10)
    # 6 samples of 12 dims: singular covariances, as 64 images of 2048-d
    # features are
    c, d = a[:6], b[:6]
    assert fid.fid_from_activations(c, d) == pytest.approx(
        jax_fid.fid_from_activations(c, d), rel=1e-10)
    assert fid.frechet_distance(m1, s1, m1, s1) == pytest.approx(0, abs=1e-8)
    logits = rng.standard_normal((30, 10)) * 3
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    for splits in (1, 3, 10, 40):
        got = inception_score.inception_score_from_probs(probs, splits)
        want = jax_is.inception_score_from_probs(probs, splits)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    np.testing.assert_allclose(inception_score.inception_score_from_probs(
        np.full((10, 4), 0.25), 5), (1.0, 0.0), atol=1e-12)


def test_verify_fid_weights_cases_of_the_jax_tests(tmp_path, monkeypatch):
    """The cases of ``tests/test_fid_weights.py``, each judged the same way
    by the JAX package's check on the same weights."""
    model = InceptionV3FID()
    ref = {k: v.numpy() for k, v in InceptionV3FID(
        with_logits=True).state_dict().items()}
    jmodel = jax_inc.InceptionV3FID()

    def both(sd, **kw):
        got = fid.verify_fid_weights(sd, model, **kw)
        want = jax_fid.verify_fid_weights(
            torch_io.inception_state_dict_to_jax(sd), jmodel, **kw)
        assert got == want
        return got

    pool3 = {k: v for k, v in ref.items() if not k.startswith("fc.")}
    assert both(pool3) == "converted"
    for width in (1008, 1000):             # a head of either family is fine
        head = dict(pool3, **{"fc.weight": np.zeros((width, 2048), np.float32),
                              "fc.bias": np.zeros(width, np.float32)})
        assert both(head) == "converted"
    missing = dict(pool3)
    del missing[sorted(missing)[0]]
    with pytest.raises(ValueError, match="do not match"):
        fid.verify_fid_weights(missing, model)
    with pytest.raises(ValueError, match="do not match"):
        jax_fid.verify_fid_weights(
            torch_io.inception_state_dict_to_jax(missing), jmodel)
    wrong = dict(pool3)
    key = "Mixed_5b.branch1x1.conv.weight"
    wrong[key] = np.zeros(wrong[key].shape + (1,), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        fid.verify_fid_weights(wrong, model)
    # a file whose sha256 starts with the canonical prefix is certified
    path = tmp_path / "w.pth"
    torch.save({k: torch.from_numpy(v) for k, v in pool3.items()}, path)
    digest = fid.fingerprint_weights_file(str(path))
    assert digest == jax_fid.fingerprint_weights_file(str(path))
    assert fid.verify_fid_weights(pool3, model, path=str(path)) == \
        "converted"
    monkeypatch.setattr(fid, "FID_WEIGHTS_SHA256_PREFIX", digest[:8])
    assert fid.verify_fid_weights(pool3, model, path=str(path)) == \
        "certified"


def test_make_feature_fn_policy(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="No FID inception weights"):
        fid.make_feature_fn(None, device="cpu")
    fn = fid.make_feature_fn(None, allow_random=True, device="cpu")
    out = fn(np.zeros((1, 64, 64, 3), np.float32))
    assert out.shape == (1, 2048) and out.dtype == np.float32
    assert "RANDOM weights" in capsys.readouterr().out
    port = port_inception(with_logits=True, size=64, calib=2)
    path = tmp_path / "w.pth"
    torch.save(port.state_dict(), path)           # with its 1008-way head
    fn = fid.make_feature_fn(str(path), device="cpu")
    assert "converted" in capsys.readouterr().out
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    pool3 = InceptionV3FID()
    pool3.load_state_dict(torch_io.inception_state_dict(
        port.state_dict(), with_logits=False))
    with torch.no_grad():
        np.testing.assert_array_equal(fn(x), pool3.eval()(nchw(x)).numpy())


def test_goldens_registry_matches_jax(tmp_path, monkeypatch):
    assert goldens.REPO_CONFIGS == jax_goldens.REPO_CONFIGS
    assert goldens.IS_WEIGHTS_SHA256_PREFIX == \
        jax_goldens.IS_WEIGHTS_SHA256_PREFIX
    assert fid.FID_WEIGHTS_SHA256_PREFIX == jax_fid.FID_WEIGHTS_SHA256_PREFIX
    path = tmp_path / "fake.pth"
    path.write_bytes(b"not the real weights")
    monkeypatch.setenv("FID_INCEPTION_PTH", str(path))
    assert goldens.golden_status() == jax_goldens.golden_status()
    assert [g.__dict__ for g in goldens.goldens()] == [
        g.__dict__ for g in jax_goldens.goldens()]
    assert goldens.find_golden("fid_inception").status()["present"]
    assert goldens.find_golden("nope") is None
