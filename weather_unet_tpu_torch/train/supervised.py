"""Supervised pretraining steps: the weather classifier and the signal
estimator -- the port of ``weather_unet_tpu/train/supervised.py``
(reference ``classifier.py:132-184``, ``estimator.py:170-227``), over a
ResNet-101.

* classifier: softmax cross entropy on 5 weather classes (Adam(1e-4, wd
  1e-4), ``classifier.py:115-117``);
* estimator: the reference computes per-column MSE with
  ``reduction='none'``, means over the batch and calls
  ``loss.backward(ones(5))`` (``estimator.py:183-187``): the gradient of the
  sum of per-column batch-mean squared errors, which is the loss here;
* BatchNorm updates its batch statistics in train mode
  (``models/common.py::BatchNorm2d``).

Under a process group the step all-reduces the gradients after the
backward and before Adam, with the metrics, in one flat bucket
(``parallel/mesh.py::all_reduce_mean``); ``train/loops.py::
train_supervised`` with a plan of several ranks also has BatchNorm reduce
its batch moments over the ranks, so the step is the global batch's.

A step ``step(state, images NCHW, targets) -> (state, metrics)`` runs the
module in train mode, updates its parameters in place with the state's
optimizer and returns device-tensor metrics; losses are computed in
float32 whatever the compute dtype.  Its device work is ``step.program``
(no host counter), which the AOT tier captures as a CUDA graph.

``--pre_trained`` freezes conv1, bn1 and layer1-3 (``estimator.py:145-153``:
children 1..7 of the torchvision ResNet): their parameters get
``requires_grad=False`` and stay out of Adam, as torch's ``Adam`` skips a
parameter without a gradient in the reference.  The JAX package zeroes
their gradients instead, but its coupled weight decay is added after that
mask, so Adam moves each "frozen" parameter by about lr * sign(p) a step;
the port does not copy that.
"""

from __future__ import annotations

from typing import Callable, FrozenSet

import torch
import torch.nn as nn
import torch.nn.functional as F

from weather_unet_tpu_torch.core.optim import torch_adam
from weather_unet_tpu_torch.core.state import TrainState
from weather_unet_tpu_torch.ops import losses
from weather_unet_tpu_torch.parallel.mesh import (
    all_reduce_mean, data_parallel)

FROZEN_PREFIXES = ("conv1.", "bn1.", "layer1.", "layer2.", "layer3.")


def resnet_pretrained_frozen(model: nn.Module) -> FrozenSet[str]:
    """Names of the parameters that ``--pre_trained`` freezes: conv1, bn1
    and layer1-3, leaving layer4 and fc trainable."""
    return frozenset(n for n, _ in model.named_parameters()
                     if n.startswith(FROZEN_PREFIXES))


def build_supervised_state(model: nn.Module, lr: float, weight_decay: float,
                           pre_trained: bool = False) -> TrainState:
    """The model with torch Adam (coupled weight decay) over its trainable
    parameters; with ``pre_trained`` the backbone is frozen first."""
    if pre_trained:
        frozen = resnet_pretrained_frozen(model)
        for n, p in model.named_parameters():
            if n in frozen:
                p.requires_grad_(False)
    params = [p for p in model.parameters() if p.requires_grad]
    return TrainState(model, torch_adam(params, lr,
                                        weight_decay=weight_decay))


def _update(state: TrainState, loss: torch.Tensor, metrics: dict) -> None:
    """Backward and Adam; under a process group the gradients and
    ``metrics`` (replaced in place) are averaged over the ranks between
    the two, in one bucket."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if data_parallel():
        params = [p for p in state.module.parameters()
                  if p.grad is not None]
        keys = list(metrics)
        out = all_reduce_mean([p.grad for p in params]
                              + [metrics[k] for k in keys])
        for p, g in zip(params, out):
            p.grad = g
        metrics.update(zip(keys, out[len(params):]))
    state.optimizer.step()


def stepped(program: Callable) -> Callable:
    """The step around its device work: ``step(state, images, targets) ->
    (state, metrics)`` runs ``program(state, images, targets) -> metrics``
    and then advances ``state.step`` on the host, which a CUDA graph of the
    program would not (``train/loops.py``'s AOT tier graphs
    ``step.program``)."""

    def step(state: TrainState, images: torch.Tensor, targets: torch.Tensor):
        metrics = program(state, images, targets)
        state.step += 1
        return state, metrics

    step.program = program
    return step


def make_classifier_step():
    """One classifier train step.  ``accuracy`` is the reference's
    ``precision`` (``classifier.py:41-43``: mean(argmax == labels))."""

    def program(state: TrainState, images: torch.Tensor,
                labels: torch.Tensor):
        state.module.train()
        logits = state.module(images).float()
        loss = losses.cross_entropy_loss(logits, labels)
        acc = (logits.detach().argmax(1) == labels).float().mean()
        metrics = {"loss": loss.detach(), "accuracy": acc}
        _update(state, loss, metrics)
        return metrics

    return stepped(program)


def make_estimator_step():
    """One estimator (signal regressor) train step: the loss is the sum over
    signal columns of the per-column batch-mean squared error."""

    def program(state: TrainState, images: torch.Tensor,
                signals: torch.Tensor):
        state.module.train()
        preds = state.module(images).float()
        loss = (preds - signals).square().mean(dim=0).sum()
        preds = preds.detach()
        metrics = {"loss": loss.detach(),
                   "mse": losses.mse_loss(preds, signals),
                   "l1": losses.l1_loss(preds, signals)}
        _update(state, loss, metrics)
        return metrics

    return stepped(program)


def make_eval_metrics(kind: str):
    """The eval forward (running BN statistics, the plain module) returning
    the reference's test metrics (``classifier.py:148-160``,
    ``estimator.py:196-206``).  ``weights`` (per-sample 0/1) makes them
    means over the real rows of a padded tail batch only
    (``loops._padded_eval_batches``); None is the plain mean."""
    if kind not in ("classifier", "estimator"):
        raise ValueError(f"kind must be 'classifier' or 'estimator', not "
                         f"{kind!r}")

    @torch.no_grad()
    def evaluate(model: nn.Module, images: torch.Tensor,
                 targets: torch.Tensor, weights=None):
        was_training = model.training
        model.eval()
        try:
            out = model(images).float()
        finally:
            model.train(was_training)
        w = (torch.ones(out.shape[0], device=out.device) if weights is None
             else weights.float())

        def wmean(per_sample):
            return (per_sample.float() * w).sum() / w.sum()

        if kind == "classifier":
            nll = -F.log_softmax(out, dim=-1).gather(
                -1, targets.long()[:, None])[:, 0]
            return {"loss": wmean(nll),
                    "accuracy": wmean(out.argmax(1) == targets)}
        dims = tuple(range(1, out.ndim))
        return {"mse": wmean((out - targets).square().mean(dim=dims)),
                "l1": wmean((out - targets).abs().mean(dim=dims))}

    return evaluate
