"""The port's GAN training path against the JAX package's, on the CPU: the
train-mode cUNet (plain and use_pallas, whose K1/K2 autograd.Functions run
their plain forwards and their own backwards here), the combined GAN step
over two steps in est and cls (cross-entropy) mode, the evaluation step,
a bfloat16 step on float32 master weights, and the two repairs that make
the frozen estimator usable inside a differentiated graph.  Weights come
across through the port's converters; dropout is 0 wherever JAX is the
reference (masks carry no parity duty).

Tolerances: train forward pixel MAE < 1e-5 (tests/test_model_parity.py's
bar); parameter gradients relative 1e-4 of max(1, max|grad|); losses rtol
2e-4; updated parameters within the Adam sign-flip bound
(``assert_adam_close``); Adam moments (and the square root of the
second) within ``MOMENT_TOL`` of the network's largest element; u
within 1e-4; estimator input gradients relative 1e-4."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import weather_unet_tpu.cli.common as jax_cli_common
import weather_unet_tpu.kernels.adain_pallas as jax_adain_pallas
import weather_unet_tpu_torch.models.common as port_common
import weather_unet_tpu_torch.models.cunet as port_cunet
from tests.test_torch_resnet import jax_resnet_variables
from tests.torch_port_util import (  # noqa: F401
    nchw, nhwc, no_thread_left, one_torch_thread)
from weather_unet_tpu.models import ConditionalUNet as JaxUNet
from weather_unet_tpu.models import ResNet as JaxResNet
from weather_unet_tpu.train import gan as jax_gan
from weather_unet_tpu_torch.cli.common import load_estimator
from weather_unet_tpu_torch.compat import torch_io
from weather_unet_tpu_torch.core.rng import train_generator
from weather_unet_tpu_torch.kernels.bottleneck import fused_resnet_eval
from weather_unet_tpu_torch.models import ConditionalUNet
from weather_unet_tpu_torch.train.gan import (
    GanConfig, build_gan_state, make_eval_step, make_gan_step)

SIZE, BATCH, LR = 16, 2, 1e-4
# Adam moments against the jitted JAX step, relative to the network's largest
# element: G 5e-3, D 1e-4.  XLA's whole-step compile moves the cUNet's
# gradients by up to 1.3e-3 of the largest one from the same JAX function
# run op by op (measured on this test's first step; the port agrees with the
# op-by-op gradients at 1e-6, see test_train_forward_and_grads_match_jax);
# D's agree at 1e-6 either way.
MOMENT_TOL = (5e-3, 1e-4)


def as_tensors(sd):
    return {k: torch.from_numpy(np.array(a)) for k, a in sd.items()}


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def assert_adam_close(got, want, lr, step, name):
    """Parameters after one update from the same state, tolerant to Adam's
    sign amplification, as tests/test_gan_training_parity.py holds the torch
    mirror: with beta1 = 0 an update is about lr * sign(g), so where g is
    below the float noise of the gradient the two frameworks may step apart.
    Bulk agreement at 5e-5 (fewer than 0.5% of the elements beyond it) and
    no element beyond 1.1 times the largest split, 2 * lr * sqrt(step): at
    the k-th update, after earlier gradients of ~0, Adam's bias-corrected
    update reaches sqrt(k) * lr (2.2 * lr at the first, as in that test)."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    frac_loose = float((diff > 5e-5).mean())
    assert frac_loose < 5e-3, f"{name}: {frac_loose:.4%} elements loose"
    split = 2.0 * lr * np.sqrt(step)
    assert diff.max() <= 1.1 * split + 1e-6, f"{name}: max {diff.max()}"


def interpret_adain(monkeypatch):
    """Run the JAX package's Pallas AdaIN in interpret mode on the CPU, as
    tests/test_kernels.py does."""
    orig = jax_adain_pallas.adain_fused
    monkeypatch.setattr(jax_adain_pallas, "adain_fused",
                        lambda x, y, eps=1e-5, interpret=False:
                        orig(x, y, eps, True))


def spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def wrapped(*args, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, wrapped)


@pytest.fixture(scope="module")
def unet():
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
    c = rng.standard_normal((BATCH, 5)).astype(np.float32)
    variables = JaxUNet(num_classes=5, dropout_rate=0.0).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(c))
    return variables, as_tensors(torch_io.cunet_state_dict_from_jax(
        variables)), x, c


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["plain", "use_pallas"])
def test_train_forward_and_grads_match_jax(unet, monkeypatch, use_pallas):
    """Train-mode forward at dropout 0 and the gradient of sum(sin(3y)) with
    respect to every parameter.  With use_pallas, JAX's AdaIN is its Pallas
    kernel's custom_vjp and the port's AdaIN and upsample are K1's and K2's
    autograd.Functions; fuse_upconv=True is set too and must run no K3 in
    train mode."""
    variables, sd, x, c = unet
    if use_pallas:
        interpret_adain(monkeypatch)
    jmodel = JaxUNet(num_classes=5, dropout_rate=0.0, use_pallas=use_pallas)

    def loss(params):
        y = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(c),
                         train=True)
        return jnp.sum(jnp.sin(3.0 * y)), y

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    want_g = torch_io.cunet_state_dict_from_jax({"params": grads})

    calls = {}
    for module, name in ((port_cunet, "adain_fused"),
                         (port_cunet, "upsample2x_fused"),
                         (port_common, "upconv_block_fused")):
        spy(monkeypatch, module, name, calls)
    port = ConditionalUNet(5, dropout_rate=0.0, use_pallas=use_pallas,
                           fuse_upconv=use_pallas)
    port.load_state_dict(sd, strict=True)
    y = port(nchw(x), torch.from_numpy(c), train=True)
    mae = float(np.abs(nhwc(y) - np.asarray(want)).mean())
    assert mae < 1e-5, mae
    torch.sin(3.0 * y).sum().backward()
    want_calls = ({"adain_fused": 3, "upsample2x_fused": 3} if use_pallas
                  else {})
    assert calls == want_calls                        # no K3 in train mode
    for name, p in port.named_parameters():
        if ".emb." in name:                           # unused by the forward
            assert p.grad is None
            continue
        assert rel_err(p.grad.numpy(), want_g[name]) <= 1e-4, name


def states(mode):
    """The JAX and the port's GAN states from one JAX init, their steps, and
    a linear estimator head on mean-pooled pixels (NHWC in JAX, NCHW in the
    port)."""
    kw = dict(input_size=SIZE, batch_size=BATCH, dropout_rate=0.0, lr=LR)
    if mode == "cls_ce":
        kw.update(mode="cls", cross_ent=True)
    jcfg, cfg = jax_gan.GanConfig(**kw), GanConfig(**kw)
    jgen, jdisc, jstate = jax_gan.build_gan_state(jcfg, jax.random.key(0))
    est_w = np.random.default_rng(5).standard_normal((3, 5)).astype(
        np.float32)
    w_t = torch.from_numpy(est_w)

    def jest(images):
        return jnp.mean(images, axis=(1, 2)) @ jnp.asarray(est_w)

    def est(images):
        return images.mean(dim=(2, 3)) @ w_t.to(images.dtype)

    gen, disc, state = build_gan_state(cfg, 0, "cpu")
    load_jax_state(state, jstate)
    return (jcfg, jgen, jdisc, jstate, jest), (cfg, gen, disc, state, est)


def jax_sds(jstate, trees=None):
    """The JAX GAN state's parameters (or ``trees(jax TrainState)``, for
    example its Adam moments) as the port's state dicts (numpy)."""
    pick = trees or (lambda ts: ts.params)
    return (torch_io.cunet_state_dict_from_jax({"params": pick(jstate.gen)}),
            torch_io.sndisc_state_dict_from_jax(
                {"params": pick(jstate.disc), "spectral": jstate.spectral}))


def adam_moments(jstate):
    """(count, first moments, second moments) of the JAX Adam states, as the
    port's state dicts (gan_adam's chain: decay, scale_by_adam, scale)."""
    return (int(jstate.gen.opt_state[1].count),
            jax_sds(jstate, lambda ts: ts.opt_state[1].mu),
            jax_sds(jstate, lambda ts: ts.opt_state[1].nu))


def load_jax_state(state, jstate):
    """Put the JAX GAN state into the port's: parameters, u, and, once JAX's
    Adam has stepped, its moments and count."""
    g_sd, d_sd = jax_sds(jstate)
    state.gen.module.load_state_dict(as_tensors(g_sd), strict=True)
    state.disc.module.load_state_dict(as_tensors(d_sd), strict=True)
    count, mu, nu = adam_moments(jstate)
    if count == 0:
        return
    for ts, m1, m2 in zip((state.gen, state.disc), mu, nu):
        for name, p in ts.module.named_parameters():
            if name in m1 and ".emb." not in name:    # emb: not in JAX
                ts.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.from_numpy(np.array(m1[name])),
                    "exp_avg_sq": torch.from_numpy(np.array(m2[name]))}


def port_sds(gen, disc):
    g = {k: v.detach().numpy() for k, v in gen.state_dict().items()
         if ".emb." not in k}
    d = {k: v.detach().numpy() for k, v in disc.state_dict().items()}
    return g, d


def port_moments(state):
    """The port's Adam moments as two pairs of state dicts (numpy)."""
    out = []
    for key in ("exp_avg", "exp_avg_sq"):
        out.append(tuple(
            {n: ts.optimizer.state[p][key].numpy()
             for n, p in ts.module.named_parameters()
             if p in ts.optimizer.state}
            for ts in (state.gen, state.disc)))
    return out


@pytest.mark.parametrize("mode", ["est", "cls_ce"])
def test_gan_step_matches_jax(mode):
    """Two combined steps from one JAX init, each held to JAX's: losses,
    updated parameters, u, and after the first the Adam moments.  Before the
    second step the port takes JAX's state (parameters, moments, u): an
    element whose gradient lies below the float noise of the gradient takes
    a random Adam step (+-lr) in either framework, and those splits compound
    (measured on est mode: 0.09%, 1.3%, 18% of G's elements beyond 5e-5
    after one, two, three unsynchronized steps, the same growth as the port
    against itself with its weights perturbed by 1e-7 relative)."""
    (jcfg, jgen, jdisc, jstate, jest), (cfg, gen, disc, state, est) = (
        states(mode))
    jstep = jax.jit(functools.partial(
        jax_gan.make_gan_step(jgen, jdisc, jest, jcfg), do_g=True))
    step = make_gan_step(gen, disc, est, cfg)
    rng = np.random.default_rng(13)
    labels = np.array([1, 3], np.int32)
    generator = train_generator(0, "cpu")
    for i in (1, 2):
        if i == 2:
            load_jax_state(state, jstate)
        images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(
            np.float32)
        rand = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(images), jnp.asarray(labels),
                           jnp.asarray(rand), jnp.asarray(labels),
                           jax.random.key(i))
        state, m = step(state, nchw(images), torch.from_numpy(labels),
                        nchw(rand), torch.from_numpy(labels), generator,
                        do_g=True)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                       err_msg=f"{k} step {i}")
        got, want = port_sds(gen, disc), jax_sds(jstate)
        for g_sd, w_sd, what in zip(got, want, ("gen", "disc")):
            params = sorted(k for k in g_sd
                            if not k.endswith(("weight_u", "weight_v")))
            assert_adam_close(
                np.concatenate([g_sd[k].ravel() for k in params]),
                np.concatenate([np.asarray(w_sd[k]).ravel()
                                for k in params]), LR, i, f"{what} step {i}")
        for k in got[1]:
            if k.endswith("weight_u"):
                np.testing.assert_allclose(got[1][k], want[1][k], atol=1e-4,
                                           err_msg=f"u {k} step {i}")
        if i == 1:     # Adam's moments: the gradient and its square
            count, *jax_moments = adam_moments(jstate)
            assert count == 1
            for pair, jpair, root in zip(port_moments(state), jax_moments,
                                         (False, True)):
                for g_sd, w_sd, tol in zip(pair, jpair, MOMENT_TOL):
                    assert set(g_sd) <= set(w_sd)
                    a = np.concatenate([g_sd[k].ravel() for k in g_sd])
                    b = np.concatenate([np.asarray(w_sd[k]).ravel()
                                        for k in g_sd])
                    if root:
                        a, b = np.sqrt(a), np.sqrt(b)
                    # relative to the network's largest element: the float
                    # noise of a gradient is that of its largest terms
                    assert np.abs(a - b).max() <= tol * np.abs(b).max()
    assert state.global_step == int(jstate.global_step) == 2
    assert state.gen.step == state.disc.step == 2


def test_eval_step_matches_jax():
    (jcfg, jgen, jdisc, jstate, jest), (cfg, gen, disc, state, est) = (
        states("est"))
    rng = np.random.default_rng(17)
    images = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = rng.standard_normal((BATCH, 5)).astype(np.float32)
    refs = rng.standard_normal((BATCH, 5)).astype(np.float32)
    jm, jfakes = jax.jit(jax_gan.make_eval_step(jgen, jdisc, jest, jcfg))(
        jstate, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(refs),
        jax.random.key(0))
    u_before = {k: v.clone() for k, v in disc.state_dict().items()
                if k.endswith("weight_u")}
    m, fakes = make_eval_step(gen, disc, est, cfg)(
        state, nchw(images), torch.from_numpy(labels),
        torch.from_numpy(refs), train_generator(0, "cpu"))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    assert fakes.shape == (BATCH, BATCH, 3, SIZE, SIZE)
    want = np.asarray(jfakes)                    # (B_ref, B, H, W, 3)
    got = fakes.permute(0, 1, 3, 4, 2).numpy()
    assert float(np.abs(got - want).mean()) < 1e-5
    assert all(torch.equal(disc.state_dict()[k], u) for k, u in
               u_before.items())                 # D read u, did not move it
    assert state.global_step == 0


def test_bf16_step_keeps_float32_master_weights():
    cfg = GanConfig(input_size=SIZE, batch_size=BATCH, dtype=torch.bfloat16,
                    dropout_rate=0.3)
    gen, disc, state = build_gan_state(cfg, 1, "cpu")
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(2))
    step = make_gan_step(gen, disc, lambda x: x.mean(dim=(2, 3))
                         @ w.to(x.dtype), cfg)
    before = {k: v.clone() for k, v in {**{"g." + k: v for k, v in
                                           gen.state_dict().items()},
                                        **{"d." + k: v for k, v in
                                           disc.state_dict().items()}}.items()}
    g = train_generator(3, "cpu")
    x = torch.rand(BATCH, 3, SIZE, SIZE, generator=g) * 2 - 1
    r = torch.rand(BATCH, 3, SIZE, SIZE, generator=g) * 2 - 1
    z = torch.zeros(BATCH, dtype=torch.long)
    metrics = {}
    for do_g in (True, False):
        state, m = step(state, x, z, r, z, g, do_g=do_g)
        metrics.update(m)
    assert len(metrics) == 6
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert gen(x, x.new_zeros(BATCH, 5), train=True,
               generator=g).dtype == torch.bfloat16
    for module in (gen, disc):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    after = {**{"g." + k: v for k, v in gen.state_dict().items()},
             **{"d." + k: v for k, v in disc.state_dict().items()}}
    changed = {k for k in after if not torch.equal(after[k], before[k])}
    # every trained weight moved; the unused embeddings and the one-element
    # u of the 512 -> 1 head did not
    assert changed == {k for k in after if ".emb." not in k
                       and k != "d.l.weight_u"}
    assert (state.global_step, state.gen.step, state.disc.step) == (2, 1, 2)


@pytest.mark.parametrize("repair", ["estimator_grad", "fused_logits_in_graph"])
def test_frozen_estimator_in_a_graph(repair, tmp_path, monkeypatch):
    """load_estimator's apply is differentiable with respect to its NHWC
    images (jax.grad through JAX's load_estimator, depth (1, 1, 1, 1), 32x32,
    f32), and fused_resnet_eval's logits can enter a differentiated graph."""
    counts = (1, 1, 1, 1)
    _, variables = jax_resnet_variables(counts=counts, num_classes=5,
                                        size=32, seed=7)
    path = str(tmp_path / "estimator.pt")
    torch.save(as_tensors(torch_io.resnet_state_dict_from_jax(variables)),
               path)
    x = np.random.default_rng(19).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    apply = load_estimator(path, device="cpu")
    assert not any(p.requires_grad for p in apply.model.parameters())
    if repair == "estimator_grad":
        monkeypatch.setattr(
            jax_cli_common, "ResNet101",
            lambda num_classes, dtype: JaxResNet(
                block_counts=counts, num_classes=num_classes, dtype=dtype))
        jax_apply = jax_cli_common.load_estimator(path)
        want = jax.grad(lambda im: jnp.sum(jax_apply(im)))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        apply(xt).sum().backward()
        assert rel_err(xt.grad.numpy(), want) <= 1e-4
    else:
        logits = fused_resnet_eval(apply.model)(nchw(x))
        assert not logits.is_inference() and not logits.requires_grad
        w = torch.ones(5, requires_grad=True)
        (logits * w).sum().backward()
        torch.testing.assert_close(w.grad, logits.sum(dim=0))
        with torch.no_grad():
            plain = apply(x)
        assert rel_err(logits.numpy(), plain.numpy()) <= 2e-4
