"""Frozen copy of the port's ``models/losses.py`` (plain PyTorch only: no CUDA
kernel, no import of the port).  Part of the benchmark's float32
reference; see ``benchmark/reference/__init__.py``.

Original docstring:

Losses of the training step (port of the JAX package's
``models/losses.py``): masked NLL and the multi-class Lovász-Softmax over
present classes (Berman et al., CVPR 2018), combined 50/50 on the last
frame of each sequence.

Invalid (padded) points and ``ignore_index`` points carry zero weight; in
the Lovász loss their error is 0, so they sort last and do not move the
cumulative-sum gradient.
"""

from __future__ import annotations

import torch


def nll_loss(logp: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
             ignore_index: int = 0) -> torch.Tensor:
    """Mean negative log-likelihood over valid, non-ignored points
    (``torch.nn.NLLLoss(ignore_index)`` on log-softmax input)."""
    valid = mask & (targets != ignore_index)
    safe_t = torch.where(valid, targets, torch.zeros_like(targets))
    picked = logp.gather(1, safe_t[:, None].long())[:, 0]
    w = valid.to(logp.dtype)
    return -(picked * w).sum() / torch.clamp(w.sum(), min=1.0)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the sorted errors
    (Berman et al., alg. 1); ``gt_sorted`` (..., P) 0/1 in error order."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, dim=-1)
    union = gts + torch.cumsum(1.0 - gt_sorted, dim=-1)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def lovasz_softmax(logp: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """Multi-class Lovász-Softmax over the classes present among the valid
    points, all classes at once.

    Per class, the errors are sorted in descending order by a stable sort,
    so ties keep their original index order, as the JAX package's
    ``lax.sort`` on the negated errors orders them.  The Lovász gradient
    weights are constants (detached), as in the reference's
    ``torch.dot(errors_sorted, grad)``.
    """
    probs = torch.exp(logp)                               # (P, C)
    nc = logp.shape[1]
    valid = mask & (targets != ignore_index)
    vf = valid.to(logp.dtype)
    classes = torch.arange(nc, device=logp.device)
    fg = (targets[None, :] == classes[:, None]).to(logp.dtype) * vf  # (C, P)
    errors = (fg - probs.t()).abs() * vf
    order = torch.sort(errors.detach(), dim=1, descending=True,
                       stable=True).indices
    grad = _lovasz_grad(fg.gather(1, order))
    w = torch.empty_like(grad).scatter_(1, order, grad)   # unsorted weights
    losses = (errors * w.detach()).sum(dim=1)
    present = (fg.sum(dim=1) > 0).to(logp.dtype)
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def segmentation_loss(logp, targets, mask, ignore_index: int = 0):
    """0.5 Lovász + 0.5 NLL, and the two parts."""
    l_lov = lovasz_softmax(logp, targets, mask, ignore_index)
    l_nll = nll_loss(logp, targets, mask, ignore_index)
    return 0.5 * l_lov + 0.5 * l_nll, {"lovasz": l_lov, "nll": l_nll}
