"""Cumulative sums for the chunked scans, kept as float32 ``hi + lo`` pairs.

The chunked scans (``rwkv6_scan/chunked.py``, ``mamba2_ssd/chunked.py``)
weigh pairs of steps by ``exp(W_t - W_s)``, a difference of two cumsums of
log decays.  A strong decay makes |W| reach hundreds within a chunk, and a
difference of two float32 cumsums then carries an error of about eps |W|
however small the difference itself: the small exponents of nearby pairs
lose their digits.  Taken in float64 and split into float32 ``hi`` and
``lo``, the exponent ``(hi_t - hi_s) + (lo_t - lo_s)`` is accurate to a
float32 rounding of the exponent itself.  The CUDA kernels do the same.
The reference's chunked forms take float32 cumsums; its own
``test_rwkv6_chunked_matches_ref`` draws such decays and fails on some.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor

Pair = Tuple[Tensor, Tensor]


def _split(a: Tensor) -> Pair:
    hi = a.float()
    return hi, (a - hi.double()).float()


def split_cumsums(x: Tensor, dim: int) -> Tuple[Pair, Pair]:
    """Inclusive and exclusive cumsums of ``x`` along ``dim``, taken in
    float64, each as float32 ``(hi, lo)`` with ``hi + lo`` the sum."""
    x64 = x.double()
    inc = torch.cumsum(x64, dim=dim)
    return _split(inc), _split(inc - x64)
