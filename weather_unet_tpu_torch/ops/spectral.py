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
                    n_iter: int = 1):
    """Power iteration on ``w_mat`` (out, in); returns ``(sigma, u, v)``.

    ``u`` and ``v`` come back detached and are never the tensor passed in,
    so a caller may write them into its buffers in place while ``sigma``'s
    graph still holds them."""
    with torch.no_grad():
        w_ng = w_mat.detach()
        u = u.detach().clone()
        if update:
            for _ in range(n_iter):
                v = _l2norm(w_ng.t() @ u)
                u = _l2norm(w_ng @ v)
        else:
            v = _l2norm(w_ng.t() @ u)
    sigma = u @ (w_mat @ v)
    return sigma, u, v


def weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> (O, I*H*W); a linear ``(out, in)`` weight as is
    (torch's own reshape for spectral norm)."""
    if weight.dim() == 4:
        return weight.reshape(weight.shape[0], -1)
    if weight.dim() == 2:
        return weight
    raise ValueError(f"unsupported weight rank {weight.dim()}")


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, update: bool):
    """``weight`` (OIHW conv or ``(out, in)`` linear) divided by its spectral
    norm.  Returns ``(weight / sigma, new_u, v)``."""
    sigma, new_u, v = power_iteration(weight_matrix(weight), u, update)
    return weight / sigma, new_u, v
