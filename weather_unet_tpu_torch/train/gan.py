"""Semi-supervised adversarial weather-transfer training step -- the port of
``weather_unet_tpu/train/gan.py`` (reference ``t_est_train.py:214-283`` /
``t_cls_train.py:226-312``).

One combined step updates the discriminator with the hinge loss, then (when
``do_g``) the generator with the adversarial + distance-weighted
reconstruction + weather-consistency losses.  The semantics are the JAX
package's:

* the estimator conditions are computed under ``torch.no_grad()`` where the
  reference ``.detach()``-es them, but gradients DO flow through
  ``est_apply(fake)`` into G;
* the spectral-norm ``u`` advances once per D forward in call order:
  D(real), D(fake) in the D update, then D(fake) in the G update -- 3 per
  combined step;
* the G update sees the already-updated discriminator;
* G's two forwards (D step, G step) draw independent dropout masks from the
  one generator passed in;
* optimizers are torch Adam with betas (0.0, 0.999), wd = lr/20;
* ``loss_con``'s eps is 1e-7 semi-supervised, 1e-2 supervised.

Images are NCHW tensors on the models' device in [-1, 1];
``est_apply(images NCHW) -> (B, num_classes)`` is the frozen weather net's
raw output (signals in est mode, logits in cls mode) and must be
differentiable with respect to its input.  ``cli/common.py::load_estimator``
takes NHWC images: wrap it as ``lambda x: apply(x.permute(0, 2, 3, 1))``
(the permuted view is the same memory, which the module permutes back).
The step mutates the state's modules and optimizers in place and returns
the state with its metrics (0-d tensors on the device, not synchronized).

Under a process group each rank steps on its data row's rows of the global
batch and all-reduces each network's gradients between ``autograd.grad``
and Adam over its data group, in one flat bucket that also carries the
metrics known by then (``parallel/mesh.py::all_reduce_mean``): every loss
is a batch mean, so the mean over equal shards of the rows is the global
batch's gradient and loss, and the ranks' states stay equal.  With the
networks split by ``parallel/tp.py`` the split convs sum over the model
group inside the forward and backward; a split parameter's gradient (and
so Adam's moments) is its shard's, and a parameter every shard holds whole
gets the same gradient on each with no further sum.

With both networks marked by ``parallel/spatial.py::spatial_`` and the
images placed by ``plan.spatial()`` (each rank of a data row holds rows of
its images), the losses and logits are the whole images' on every shard
(sums over the data row's shards), the frozen estimator runs on the
gathered whole images, each shard backpropagates the replicated loss
divided by the degree, and each parameter's gradient is summed over the
shards before the data-group mean: the parameters stay replicated.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from weather_unet_tpu_torch._device import DeviceLike, resolve_device
from weather_unet_tpu_torch.core.optim import gan_adam
from weather_unet_tpu_torch.core.state import GanTrainState, TrainState
from weather_unet_tpu_torch.models.cunet import ConditionalUNet
from weather_unet_tpu_torch.models.sndisc import SNDisc
from weather_unet_tpu_torch.ops import losses
from weather_unet_tpu_torch.parallel import spatial
from weather_unet_tpu_torch.parallel.mesh import (
    all_reduce_mean, data_parallel)


@dataclasses.dataclass(frozen=True)
class GanConfig:
    """The JAX package's ``GanConfig``: flag parity with the reference
    training scripts (``t_est_train.py:4-30``, ``t_cls_train.py:14-41``)."""

    num_classes: int = 5
    lr: float = 1e-4
    input_size: int = 224
    batch_size: int = 8
    gd_train_ratio: int = 1
    mode: str = "est"            # 'est' (t_est_train) | 'cls' (t_cls_train)
    supervised: bool = False     # cls mode: use dataset one-hot labels
    cross_ent: bool = False      # cls mode: CE on estimator logits
    dataset: str = "flicker"     # cls mode: 'flicker' | 'i2w'
    lmda: Optional[float] = None
    num_epoch: int = 50
    dtype: torch.dtype = torch.float32
    dropout_rate: float = 0.3    # reference cunet.py:28; 0.0 for parity tests

    @property
    def con_eps(self) -> float:
        return 1e-2 if self.supervised else 1e-7


def build_gan_state(cfg: GanConfig, seed: int, device: DeviceLike = None,
                    *, use_pallas: bool = False):
    """Generator and discriminator initialized from ``seed`` (drawn on the
    CPU, so every device gets the same weights), moved to ``device`` (CUDA
    unless given), with their optimizers.  Parameters are float32 whatever
    ``cfg.dtype`` (the compute dtype).  ``use_pallas`` routes the
    generator's decoder AdaINs and upsamples through K1 and K2.  Returns
    ``(gen, disc, state)``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    gen = ConditionalUNet(cfg.num_classes, cfg.dropout_rate, dtype=cfg.dtype,
                          use_pallas=use_pallas, param_dtype=torch.float32,
                          generator=g).to(device)
    disc = SNDisc(cfg.num_classes, dtype=cfg.dtype, generator=g).to(device)
    state = GanTrainState(
        gen=TrainState(gen, gan_adam(gen.parameters(), cfg.lr)),
        disc=TrainState(disc, gan_adam(disc.parameters(), cfg.lr)))
    return gen, disc, state


def _apply_gradients(ts: TrainState, loss: torch.Tensor,
                     metrics: dict, group=None) -> None:
    """One optimizer step on the gradient of ``loss`` with respect to the
    state's own parameters only (the other network's are not touched); the
    update count is the caller's (host counters stay out of a step's device
    work, which a CUDA graph replays without running this code).  A
    parameter the loss does not use (the cUNet's ``adain{i}.emb``, absent
    from the JAX model) gets no gradient, so Adam leaves it as it is.
    Under a process group the gradients and ``metrics`` (replaced in place)
    are averaged over the ranks in one bucket first.  Under spatial
    partitioning (``group``) each shard's gradient of the replicated loss
    divided by the degree is summed over the shards first."""
    params = [p for p in ts.module.parameters() if p.requires_grad]
    grads = list(torch.autograd.grad(loss / group.n if group else loss,
                                     params, allow_unused=True))
    if group is not None:
        grads = spatial.sum_gradients(group, grads)
    if data_parallel():
        used = [i for i, g in enumerate(grads) if g is not None]
        keys = list(metrics)
        out = all_reduce_mean([grads[i] for i in used]
                              + [metrics[k] for k in keys])
        for i, g in zip(used, out):
            grads[i] = g
        metrics.update(zip(keys, out[len(used):]))
    for p, g in zip(params, grads):
        p.grad = g
    ts.optimizer.step()
    ts.optimizer.zero_grad(set_to_none=True)


def _check_state(state: GanTrainState, gen, disc) -> None:
    if state.gen.module is not gen or state.disc.module is not disc:
        raise ValueError("the state's modules are not the gen and disc the "
                         "step was made for")


def make_gan_step(gen: ConditionalUNet, disc: SNDisc, est_apply: Callable,
                  cfg: GanConfig):
    """Build the combined train step.

    Returns ``step(state, images, c_d, rand_images, c_r, generator, *,
    do_g) -> (state, metrics)``: ``c_d`` / ``c_r`` are int class labels
    (cls mode; ignored in est mode), ``generator`` a ``torch.Generator`` on
    the images' device for the dropout masks, ``do_g`` the
    ``gd_train_ratio`` gate.

    ``step.programs`` maps ``do_g`` to the step's device work,
    ``program(state, images, c_d, rand_images, c_r, generator) ->
    metrics``; ``step`` runs one and then advances the host counters.  The
    trainer's AOT tier replaces the two programs with their CUDA graphs
    (``train/loops.py::_tiered_steps``)."""
    n_cls = cfg.num_classes
    cls_ce = cfg.mode == "cls" and cfg.cross_ent
    group = spatial.group_of(gen)
    if (spatial.group_of(disc) is None) != (group is None):
        raise ValueError("under spatial partitioning both networks are "
                         "marked (parallel/spatial.py::spatial_)")
    if group is not None:
        # the frozen estimator sees whole images, the same on every shard
        est_rows = est_apply

        def est_apply(images):
            return est_rows(group.gather_rows(images))

    def conditions_from(images):
        out = est_apply(images)
        if cfg.mode == "cls":
            out = torch.softmax(out, dim=1)
        return out

    def device_step(state: GanTrainState, images, c_d, rand_images, c_r,
                    generator: Optional[torch.Generator], *, do_g: bool):
        if cfg.mode == "cls" and cfg.supervised:
            rand_labels = F.one_hot(c_r.long(), n_cls).to(images.dtype)
            pred_labels = F.one_hot(c_d.long(), n_cls).to(images.dtype)
        else:
            with torch.no_grad():
                rand_labels = conditions_from(rand_images)
                pred_labels = conditions_from(images)

        # ---------------- discriminator update (t_est_train.py:261-283)
        with torch.no_grad():
            fake_detached = gen(images, rand_labels, train=True,
                                generator=generator)
        real_out, _ = disc(images, pred_labels, update_stats=True)
        fake_out, _ = disc(fake_detached, rand_labels, update_stats=True)
        d_loss = losses.dis_hinge(fake_out, real_out)
        metrics = {"d_loss": d_loss.detach()}
        _apply_gradients(state.disc, d_loss, metrics, group)

        if do_g:
            # ------------- generator update (t_est_train.py:214-259)
            if cls_ce:
                # integer CE targets -- t_cls_train.py:430-438
                if cfg.supervised or cfg.dataset == "i2w":
                    ce_targets = c_r
                else:   # semi-supervised flicker: argmax of the logits
                    with torch.no_grad():
                        ce_targets = est_apply(rand_images).argmax(dim=1)
            fake = gen(images, rand_labels, train=True, generator=generator)
            fake_out, _ = disc(fake, rand_labels, update_stats=True)
            g_adv = losses.gen_hinge(fake_out)
            if cls_ce:
                g_w = losses.cross_entropy_loss(est_apply(fake), ce_targets)
            else:
                g_w = losses.mse_loss(conditions_from(fake), rand_labels)
            loss_con = losses.reconstruction_con_loss(
                fake, images, pred_labels, rand_labels, eps=cfg.con_eps,
                group=group)
            g_l1 = losses.l1_loss(fake, images, group)
            g_loss = g_adv + loss_con + g_w
            g_metrics = {k: v.detach() for k, v in (
                ("g_loss", g_loss), ("g_loss_adv", g_adv), ("g_loss_w", g_w),
                ("loss_con", loss_con), ("g_loss_l1", g_l1))}
            _apply_gradients(state.gen, g_loss, g_metrics, group)
            metrics.update(g_metrics)
        return metrics

    programs = {do_g: functools.partial(device_step, do_g=do_g)
                for do_g in (True, False)}

    def step(state: GanTrainState, images, c_d, rand_images, c_r,
             generator: Optional[torch.Generator], *, do_g: bool):
        _check_state(state, gen, disc)
        metrics = programs[bool(do_g)](state, images, c_d, rand_images, c_r,
                                       generator)
        state.disc.step += 1
        if do_g:
            state.gen.step += 1
        state.global_step += 1
        return state, metrics

    step.programs = programs
    return step


def make_eval_step(gen: ConditionalUNet, disc: SNDisc, est_apply: Callable,
                   cfg: GanConfig):
    """Test-time evaluation (``t_est_train.py:285-334``): translate the whole
    test batch to each reference sample's condition and score G/D losses.

    Returns ``eval_step(state, images, labels, ref_labels, generator) ->
    (metrics, fakes)``: the metrics averaged over the reference conditions
    and ``fakes`` (B_ref, B, 3, H, W).  As in the JAX package, G runs in
    train mode (dropout on, masks from ``generator``), ``g_loss_w`` scores
    the estimator's raw outputs in both modes, and D reads its ``u`` without
    advancing it.  A loop over the reference conditions stands in for the
    JAX package's ``vmap``; nothing here builds a graph.  Spatially split
    networks are refused (the eval step over spatial shards is not
    ported)."""
    if spatial.group_of(gen) is not None:
        raise ValueError("the evaluation step does not run spatially split "
                         "networks")

    @torch.no_grad()
    def eval_step(state: GanTrainState, images, labels, ref_labels,
                  generator: Optional[torch.Generator]):
        _check_state(state, gen, disc)
        bsz = images.shape[0]
        real_out, _ = disc(images, labels)
        per_ref, fakes = [], []
        for ref in ref_labels:
            ref_expand = ref[None, :].expand(bsz, -1)
            fake = gen(images, ref_expand, train=True, generator=generator)
            fake_out, _ = disc(fake, ref_expand)
            per_ref.append({
                "g_loss_adv": losses.gen_hinge(fake_out),
                "g_loss_l1": losses.l1_loss(fake, images),
                "g_loss_w": losses.mse_loss(est_apply(fake), ref_expand),
                "d_loss": losses.dis_hinge(fake_out, real_out)})
            fakes.append(fake)
        metrics = {k: torch.stack([m[k].float() for m in per_ref]).mean()
                   for k in per_ref[0]}
        return metrics, torch.stack(fakes)

    return eval_step
