"""Spectral normalization with explicit power-iteration state -- the port of
``weather_unet_tpu/ops/spectral.py``.

``torch.nn.utils.spectral_norm`` advances its hidden ``u`` on every
training-mode forward; the GAN's evaluation step must read ``u`` without
advancing it, so here ``u`` is an argument and the updated ``u`` a result.

The power iteration runs without gradient (``u`` and ``v`` are constants, as
torch's buffers are), while ``sigma = u @ W @ v`` keeps its dependence on
``W``: gradients flow through ``W / sigma`` as in torch.  One iteration per
updating forward, l2 normalization ``v / (|v| + 1e-12)``, and without an
update ``sigma`` comes from the stored ``u`` (``v`` recomputed from it).
"""

from __future__ import annotations

import torch

EPS = 1e-12


def _l2norm(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + EPS)


def power_iteration(w_mat: torch.Tensor, u: torch.Tensor, update: bool,
                    n_iter: int = 1, split=None):
    """Power iteration on ``w_mat`` (out, in); returns ``(sigma, u, v)``.

    ``u`` and ``v`` come back detached and are never the tensor passed in,
    so a caller may write them into its buffers in place while ``sigma``'s
    graph still holds them.

    ``split`` (``parallel/tp.py::Split``): ``w_mat`` is this shard's slice
    of the whole matrix, and the iteration is the whole matrix's.  A
    column split holds rows of it (and the shard ``u_r``): ``v =
    normalize(sum_r W_r^T u_r)``, ``u_r = W_r v / |W v|`` with the norm's
    squares summed.  A row split holds columns (and the shard ``v_r``):
    ``v_r = W_r^T u / |W^T u|`` likewise, ``u = normalize(sum_r W_r v_r)``.
    ``sigma`` is summed over the shards either way (its gradient too)."""
    column = split is not None and split.kind == "column"
    row = split is not None and split.kind == "row"

    def along_in(u):        # normalize(W^T u)
        t = w_ng.t() @ u
        if row:
            return t / (split.norm(t) + EPS)
        return _l2norm(split.vector_sum(t) if column else t)

    def along_out(v):       # normalize(W v)
        t = w_ng @ v
        if column:
            return t / (split.norm(t) + EPS)
        return _l2norm(split.vector_sum(t) if row else t)

    with torch.no_grad():
        w_ng = w_mat.detach()
        u = u.detach().clone()
        if update:
            for _ in range(n_iter):
                v = along_in(u)
                u = along_out(v)
        else:
            v = along_in(u)
    sigma = u @ (w_mat @ v)
    if split is not None:
        sigma = split.sigma(sigma)
    return sigma, u, v


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (O, I*H*W); a linear ``(out, in)`` weight as is
    (torch's own reshape for spectral norm)."""
    if weight.dim() == 4:
        return weight.reshape(weight.shape[0], -1)
    if weight.dim() == 2:
        return weight
    raise ValueError(f"unsupported weight rank {weight.dim()}")


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, update: bool,
                       split=None):
    """``weight`` (OIHW conv or ``(out, in)`` linear) divided by its spectral
    norm (the whole weight's, where ``split`` says ``weight`` is a shard of
    it).  Returns ``(weight / sigma, new_u, v)``."""
    sigma, new_u, v = power_iteration(weight_matrix(weight), u, update,
                                      split=split)
    return weight / sigma, new_u, v
