"""POTUS water-fill in PyTorch (paper Algorithm 1, DESIGN.md §7).

Only :func:`_fill_components` is ported so far: the compact one-dispatch
decision (``core/compact.py``) needs it. The price matrix, the dense
schedulers and the loop reference come with the plain scan engine.
"""
from __future__ import annotations

import torch

__all__ = ["_fill_components"]


def _fill_components(m: torch.Tensor, j_c: torch.Tensor, budget: torch.Tensor,
                     gamma: torch.Tensor):
    """Water-fill ``gamma`` against per-component budgets in ascending
    ``(price, index)`` order, over the last axis (leading axes are rows).

    ``m`` (..., C) is the cheapest candidate price per component (+inf =
    none), ``j_c`` that candidate's instance index (I = none), ``budget``
    the per-component ``q_out`` budget (0 where no candidate) and ``gamma``
    (...,) the row's budget. Returns ``(fill_sorted, j_sorted, perm)``;
    ``perm`` maps sorted positions back to component slots. The sort is
    lexicographic on ``(m, j_c)`` — two stable sorts, minor key first — so
    ties go to the lowest index as ``argmin`` does.
    """
    by_j = torch.sort(j_c, dim=-1, stable=True).indices
    by_m = torch.sort(torch.gather(m, -1, by_j), dim=-1, stable=True).indices
    perm = torch.gather(by_j, -1, by_m)
    j_sorted = torch.gather(j_c, -1, perm)
    b_sorted = torch.gather(budget, -1, perm)
    prefix = torch.cumsum(b_sorted, dim=-1)
    before = torch.cat([torch.zeros_like(prefix[..., :1]), prefix[..., :-1]], dim=-1)
    g = gamma.unsqueeze(-1)
    fill = torch.minimum(prefix, g) - torch.minimum(before, g)
    return fill, j_sorted, perm
