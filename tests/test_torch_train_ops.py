"""The port's training ops on the CPU: the losses, global pools and the GAN
Adam against the JAX package's on the same numpy inputs (1e-6: float32
reductions of at most a few hundred values; Adam 1e-7 on one update of
size lr), and the port's own properties of the initializers and the 16-bit
dropout (bounds, seeded determinism, keep rule, scale).  Dropout masks carry
no parity duty, so the dropout is held to its rule, not to JAX's stream."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tests.torch_port_util import (  # noqa: F401
    nchw, no_thread_left, one_torch_thread)
from weather_unet_tpu.core.optim import gan_adam as jax_gan_adam
from weather_unet_tpu.ops import convs as jax_convs
from weather_unet_tpu.ops import losses as jax_losses
from weather_unet_tpu_torch.core.optim import gan_adam
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.ops import convs, inits, losses
from weather_unet_tpu_torch.ops.dropout import bits_dropout, make_dropout

KEEP = 45875          # round(0.7 * 65536): rate 0.3's 16-bit threshold


def both(fn_name, *arrays, **kw):
    want = getattr(jax_losses, fn_name)(*[jnp.asarray(a) for a in arrays],
                                        **kw)
    got = getattr(losses, fn_name)(*[torch.from_numpy(np.array(a))
                                     for a in arrays], **kw)
    return float(got), float(want)


@pytest.mark.parametrize("group", ["regression", "classification",
                                   "adversarial"])
def test_losses_match_jax(rng, group):
    a = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    b = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    pairs = []
    if group == "regression":
        pairs += [both("l1_loss", a, b), both("mse_loss", a, b),
                  both("adv_loss", a, b)]
        feats_a = [rng.standard_normal(s).astype(np.float32)
                   for s in ((2, 3), (2, 4, 4))]
        feats_b = [rng.standard_normal(f.shape).astype(np.float32)
                   for f in feats_a]
        want = jax_losses.feat_loss([jnp.asarray(f) for f in feats_a],
                                    [jnp.asarray(f) for f in feats_b])
        got = losses.feat_loss([torch.from_numpy(f) for f in feats_a],
                               [torch.from_numpy(f) for f in feats_b])
        pairs.append((float(got), float(want)))
        pred = rng.standard_normal((3, 5)).astype(np.float32)
        rand = rng.standard_normal((3, 5)).astype(np.float32)
        for eps in (1e-7, 1e-2):
            pairs.append(both("reconstruction_con_loss", a, b, pred, rand,
                              eps=eps))
    elif group == "classification":
        logits = (3 * rng.standard_normal((4, 5))).astype(np.float32)
        labels = np.array([0, 4, 2, 2], np.int32)
        pairs.append(both("cross_entropy_loss", logits, labels))
        pairs.append(both("pred_loss", logits, labels, one_hot=True))
        soft = rng.standard_normal((4, 5)).astype(np.float32)
        pairs.append(both("pred_loss", logits, soft))
    else:
        fake = (2 * rng.standard_normal((6, 1))).astype(np.float32)
        real = (2 * rng.standard_normal((6, 1))).astype(np.float32)
        pairs += [both("dis_hinge", fake, real), both("gen_hinge", fake)]
    for got, want in pairs:
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_inits_bounds_and_seeded_determinism():
    shapes = {"conv": (64, 3, 3, 3), "dense": (4 * 128, 5)}
    for kind, shape in shapes.items():
        fan_in = math.prod(shape[1:])
        fan_out = shape[0] * math.prod(shape[2:])
        draws = {
            1.0 / math.sqrt(fan_in): inits.torch_kernel_init,
            math.sqrt(2.0) * math.sqrt(6.0 / (fan_in + fan_out)):
                inits.xavier_uniform(math.sqrt(2.0))}
        for bound, init in draws.items():
            w = init(shape, torch.Generator().manual_seed(1))
            assert w.shape == shape and w.dtype == torch.float32
            assert float(w.abs().max()) <= bound
            assert float(w.abs().max()) > 0.9 * bound, kind    # spans it
            again = init(shape, torch.Generator().manual_seed(1))
            other = init(shape, torch.Generator().manual_seed(2))
            assert torch.equal(w, again) and not torch.equal(w, other)
        bias = inits.torch_bias_init_for(fan_in)((shape[0],),
                                                 torch.Generator())
        assert float(bias.abs().max()) <= 1.0 / math.sqrt(fan_in)
    u = inits.normal_unit((512,), torch.Generator().manual_seed(3))
    assert abs(float(torch.linalg.vector_norm(u)) - 1.0) < 1e-6
    x = torch.zeros(4, 5)
    s1 = losses.soft_transform(x, 0.05, torch.Generator().manual_seed(5))
    s2 = losses.soft_transform(x, 0.05, torch.Generator().manual_seed(5))
    assert torch.equal(s1, s2) and 0 < float(s1.abs().max()) < 0.5
    g = train_generator(7, "cpu")
    assert g.device.type == "cpu" and g.initial_seed() == 7


def test_bits_dropout_keep_rule_and_scale():
    x = torch.linspace(-2.0, 2.0, 1 << 20).reshape(16, 16, 64, 64)
    x = x + 1e-3                              # no element is exactly 0
    assert bits_dropout(x, 0.0, torch.Generator()) is x
    assert make_dropout(0.3, deterministic=True)(x) is x
    out = bits_dropout(x, 0.3, torch.Generator().manual_seed(0))
    kept = out != 0
    # keep fraction within 4 sigma of 45875/65536 over 2^20 elements
    p, n = KEEP / 65536, x.numel()
    assert abs(float(kept.float().mean()) - p) <= 4 * math.sqrt(
        p * (1 - p) / n)
    # kept values are exactly x * 65536/45875 in x's dtype
    scale = torch.tensor(65536.0 / KEEP, dtype=torch.float32)
    assert torch.equal(out[kept], x[kept] * scale)
    same = bits_dropout(x, 0.3, torch.Generator().manual_seed(0))
    other = bits_dropout(x, 0.3, torch.Generator().manual_seed(1))
    assert torch.equal(out, same) and not torch.equal(out, other)
    # the gradient is the mask times the scale
    xg = x.clone().requires_grad_()
    bits_dropout(xg, 0.3, torch.Generator().manual_seed(0)).sum().backward()
    assert torch.equal(xg.grad, kept.float() * scale)


def test_dropout_bf16_and_impl_switch(monkeypatch):
    x = torch.randn(8, 32, 32, 32, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    out = bits_dropout(x, 0.3, torch.Generator().manual_seed(1))
    kept = out != 0
    assert out.dtype == torch.bfloat16
    scale = torch.tensor(65536.0 / KEEP, dtype=torch.bfloat16)
    assert torch.equal(out[kept], x[kept] * scale)
    assert abs(float(kept.float().mean()) - KEEP / 65536) < 0.01
    monkeypatch.setenv("WUT_DROPOUT", "torch")
    drop = make_dropout(0.3, deterministic=False)
    y = drop(x.float(), torch.Generator().manual_seed(2))
    kept = y != 0
    np.testing.assert_allclose(y[kept].numpy(), (x.float()[kept] / 0.7)
                               .numpy(), rtol=1e-6)
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    monkeypatch.setenv("WUT_DROPOUT", "bits8")
    with pytest.raises(ValueError, match="WUT_DROPOUT"):
        make_dropout(0.3, deterministic=False)


def test_global_pools_match_jax(rng):
    x = rng.standard_normal((2, 6, 5, 4)).astype(np.float32)     # NHWC
    np.testing.assert_allclose(convs.global_sum_pool(nchw(x)).numpy(),
                               np.asarray(jax_convs.global_sum_pool(x)),
                               atol=1e-6)
    np.testing.assert_allclose(convs.global_avg_pool(nchw(x)).numpy(),
                               np.asarray(jax_convs.global_avg_pool(x)),
                               atol=1e-6)


def test_gan_adam_matches_jax(rng):
    """Two updates of torch Adam (betas (0, 0.999), coupled L2 wd = lr/20)
    against the JAX package's optax chain."""
    lr = 1e-4
    w0 = rng.standard_normal((6, 7)).astype(np.float32)
    grads = [rng.standard_normal((6, 7)).astype(np.float32) for _ in range(2)]
    tx = jax_gan_adam(lr)
    params = jnp.asarray(w0)
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = gan_adam([p], lr)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               atol=1e-7)
    assert opt.param_groups[0]["betas"] == (0.0, 0.999)
    assert opt.param_groups[0]["weight_decay"] == lr / 20


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_cached_scale_is_bit_equal(dtype):
    """The keep scale is made once per (thresh, dtype, device), so a step
    captured as a CUDA graph copies nothing from the host: the results are
    bit-equal to scaling by a tensor made in each call (the former code),
    rounded to x's dtype; a scale first made under inference mode still
    serves a differentiated call."""
    from weather_unet_tpu_torch.ops import dropout

    dropout._keep_scale.cache_clear()
    x = torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    with torch.inference_mode():
        dropout.bits_dropout(x, 0.3, torch.Generator().manual_seed(0))
    out = dropout.bits_dropout(x, 0.3, torch.Generator().manual_seed(4))
    words = torch.randint(-32768, 32768, x.shape, dtype=torch.int16,
                          generator=torch.Generator().manual_seed(4))
    scale = torch.tensor(65536.0 / KEEP, dtype=dtype)
    want = torch.where(words < KEEP - 32768, x * scale,
                       torch.zeros((), dtype=dtype))
    assert torch.equal(out, want)
    assert dropout._keep_scale(KEEP, dtype, x.device) is dropout._keep_scale(
        KEEP, dtype, x.device)
    assert dropout._keep_scale.cache_info().currsize == 1
    xg = x.float().clone().requires_grad_()
    dropout.bits_dropout(xg, 0.3, torch.Generator().manual_seed(4)).sum(
    ).backward()
    assert torch.equal(xg.grad != 0, words < KEEP - 32768)
