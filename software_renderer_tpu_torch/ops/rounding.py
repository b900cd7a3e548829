"""Float32 division and square root rounded once, as on the CPU, on
every device.

torch on the card divides by a Python number as a multiplication by its
reciprocal, and its float32 square root is not correctly rounded (some
inputs land an ulp away from the CPU's on an H100). The plain
versions, the JAX package on the CPU and IEEE 754 round each operation
once; where a result must be bit-equal across devices, these helpers do
the same on the card.
"""

from __future__ import annotations

import torch


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c``, one IEEE division: the divisor is a 0-dim tensor on
    ``x``'s device, which torch divides by instead of multiplying by its
    reciprocal."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root: computed in float64 and
    rounded to float32, which rounds the float32 result correctly (53 >=
    2 * 24 + 2 bits make the double rounding innocuous)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)
