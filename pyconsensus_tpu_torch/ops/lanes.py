"""Lane arithmetic: reductions and roundings whose bits do not depend on
how many independent lanes share a tensor.

The batched cores (the simulator's ``sim/_batched.py``, the serve tier's
padded buckets in ``serve/kernels.py``) run many resolutions, one lane
each, as one torch computation. A lane must give the same bits alone and
inside any batch, so every contraction there is an elementwise product
and a sum over a fixed axis in a fixed pairwise order (:func:`fsum`),
never a library product or reduction whose algorithm may change with the
number of lanes (a batched GEMM or a reduction's launch configuration
can). Products and sums are correctly rounded on the CPU and on the card
alike, and so are divisions and square roots as :func:`div` and
:func:`sqrt` take them.
"""

from __future__ import annotations

import torch

__all__ = ["fsum", "div", "sqrt", "guard"]


def fsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in a fixed pairwise order: entry ``i`` is added to
    entry ``i + n // 2`` until one is left (an odd count adds its last
    entry into the first). Each step is one elementwise add, so the bits
    depend on the axis length alone."""
    dim = dim % x.dim()
    n = x.shape[dim]
    while n > 1:
        h = n // 2
        y = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
        if n % 2:
            y.narrow(dim, 0, 1).add_(x.narrow(dim, n - 1, 1))
        x, n = y, h
    return x.squeeze(dim)


def div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a / b`` correctly rounded on either device. torch's float32
    division and square root on the card need not round as IEEE does (its
    square root was measured one ulp from the CPU's on an H100); its
    float64 ones do, and one float64 operation rounded to float32 is the
    float32 operation's correctly rounded result (53 >= 2 * 24 + 2
    bits)."""
    if a.dtype == torch.float32:
        return (a.double() / b.double()).float()
    return a / b


def sqrt(a: torch.Tensor) -> torch.Tensor:
    """``sqrt(a)`` correctly rounded on either device (see :func:`div`)."""
    if a.dtype == torch.float32:
        return torch.sqrt(a.double()).float()
    return torch.sqrt(a)


def guard(x: torch.Tensor) -> torch.Tensor:
    """``where(x == 0, 1, x)``: a divisor that is never zero."""
    return torch.where(x == 0.0, 1.0, x)
