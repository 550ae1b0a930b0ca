"""3x3 stride-1 SAME convolution.

Port of ddpo_tpu/ops/conv.py's dispatch: JAX never picks its Pallas conv
(``_kernel_profitable`` returns False), so the product stays a library call,
as XLA's conv emitter did it there: here ``F.conv2d`` on NCHW/OIHW.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def conv3x3(
    x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x (N, Cin, H, W), weight (Cout, Cin, 3, 3) -> (N, Cout, H, W)."""
    return F.conv2d(x, weight, bias, stride=1, padding=1)
