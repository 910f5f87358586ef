"""The MNIST CNN in PyTorch: the smoke-test model of ``dist_mnist``.

Counterpart of ``tf_operator_tpu/models/mnist.py``, with flax's names
(``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``) and flax's layers from
``models/resnet.py``: ``"SAME"`` convs with a bias, ``VALID`` 2x2 average
pools, and the compute dtype bf16 by default with f32 parameters. The
head runs in f32. The flatten before ``Dense_0`` is in NHWC (h, w, c)
order, as flax flattens, so ``Dense_0``'s kernel rows keep flax's order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.resnet import Conv, Dense, to_nchw


class MnistCNN(nn.Module):
    """``forward(x, train=True)``: NHWC images ``[B, 28, 28, 1]`` to f32
    logits ``[B, num_classes]``; ``train`` changes nothing (no BatchNorm),
    as in flax. On ``device`` (default the card)."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.num_classes, self.dtype, self.device = num_classes, dtype, device
        conv = dict(use_bias=True, dtype=dtype, device=device)
        self.Conv_0 = Conv(1, 32, (3, 3), **conv)
        self.Conv_1 = Conv(32, 64, (3, 3), **conv)
        self.Dense_0 = Dense(7 * 7 * 64, 256, dtype, device)
        self.Dense_1 = Dense(256, num_classes, torch.float32, device)

    def shape_fields(self) -> dict:
        """What fixes the variable tree's shapes: a checkpoint manifest's
        record of the model."""
        return {"model": "MnistCNN", "num_classes": self.num_classes}

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = to_nchw(x.to(self.dtype))
        x = F.avg_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.avg_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x.float())
