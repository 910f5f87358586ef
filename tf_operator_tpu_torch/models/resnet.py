"""ResNet-50 (v1.5) in PyTorch: the port of the JAX package's flagship
benchmark model.

Counterpart of ``tf_operator_tpu/models/resnet.py``, module for module,
with flax's names (``Conv_0``, ``BatchNorm_0``, ``BottleneckBlock_3``,
``Dense_0``, ``stem_s2d``) as attribute names, so a parameter's dotted
name is its flax path (``models/convert.py`` carries trees across). The
layers here (``Conv``, ``BatchNorm``, ``Dense``) are flax's, not
torch's, where the two differ:

- ``Conv`` pads ``"SAME"`` as flax does, from the input size, kernel and
  stride: ``out = ceil(n / s)``, ``total = max((out - 1) s + k - n, 0)``,
  ``(total // 2, total - total // 2)``. A 3x3 stride-2 conv on an even
  input pads (0, 1), where torch's ``padding=1`` would pad (1, 1). The
  kernel is stored OIHW in ``channels_last`` memory (``convert.py``
  transposes flax's HWIO once, on load), and a ``dtype`` conv computes
  in that dtype over its f32 parameters.
- ``BatchNorm`` normalises in training with the batch's mean and biased
  variance and updates its running ``mean``/``var`` itself, flax's way:
  ``ra = 0.9 ra + 0.1 batch`` with the BIASED variance (torch's own
  running update takes the unbiased one), eps 1e-5. Parameters and
  statistics stay f32; the output is in the compute dtype.
- ``Dense`` keeps flax's ``[in, out]`` kernel.

Activations are NCHW tensors in ``channels_last`` memory: the NHWC input
(JAX's layout, ``[B, H, W, C]``) is viewed as NCHW without a copy, and
cuDNN's bf16 convolutions run fastest on that layout. The classifier
head runs in f32, as JAX's does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tf_operator_tpu_torch import resolve_device

STEMS = ("conv7", "s2d")
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax's ``"SAME"`` padding of one spatial axis: (low, high)."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: ``[B, H, W, C] -> [B, H/b, W/b, b*b*C]``, the
    output channels in (dr, dc, c) order, as ``stem_kernel_to_s2d``
    assumes."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(f"spatial dims {(h, w)} not divisible by {block}")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, block * block * c)


def stem_kernel_to_s2d(k7: np.ndarray) -> np.ndarray:
    """Embed a 7x7xCxF stride-2 stem kernel (HWIO) into the equivalent
    4x4x(4C)xF kernel over space-to-depth(2) input (stride 1, padding
    (2, 1)). Input row offset kr lands in block row (kr - 3) // 2 + 2 and
    within-block row (kr - 3) % 2; taps in the zero padding read zeros on
    both paths, so the two convolutions agree in exact arithmetic."""
    kh, kw, c, f = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"expected a 7x7 stem kernel, got {k7.shape}")
    out = np.zeros((4, 4, 4 * c, f), k7.dtype)
    for kr in range(7):
        br, dr = (kr - 3) // 2 + 2, (kr - 3) % 2
        for kc in range(7):
            bc, dc = (kc - 3) // 2 + 2, (kc - 3) % 2
            out[br, bc, (dr * 2 + dc) * c:(dr * 2 + dc + 1) * c] = k7[kr, kc]
    return out


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW: a view, whose memory is ``channels_last``."""
    return x.permute(0, 3, 1, 2)


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW activations: ``padding`` is ``"SAME"``
    or explicit ``((lo, hi), (lo, hi))`` pads; ``dtype`` is the compute
    dtype (the f32 kernel and the input are cast to it)."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: tuple[int, int], strides: int = 1,
                 padding="SAME", use_bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        kh, kw = kernel_size
        self.kernel = nn.Parameter(torch.zeros(
            features, in_features, kh, kw, device=device).contiguous(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        self.strides, self.padding, self.dtype = strides, padding, dtype

    def pads(self, h: int, w: int) -> tuple[tuple[int, int], tuple[int, int]]:
        if self.padding != "SAME":
            return self.padding
        kh, kw = self.kernel.shape[2:]
        return (same_pads(h, kh, self.strides),
                same_pads(w, kw, self.strides))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (ph0, ph1), (pw0, pw1) = self.pads(*x.shape[2:])
        x = x.to(self.dtype)
        if ph0 == ph1 and pw0 == pw1:
            pad = (ph0, pw0)
        else:
            x = F.pad(x, (pw0, pw1, ph0, ph1))
            pad = 0
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias,
                        stride=self.strides, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of NCHW activations: f32 ``scale``/``bias`` parameters and f32
    running ``mean``/``var`` buffers (flax's ``batch_stats``).

    In training the output uses the batch's mean and biased variance, and
    the running statistics become ``0.9 ra + 0.1 batch``, the variance
    the biased one. The batch statistics come out of the same
    ``F.batch_norm`` call that normalises: it writes the batch mean and
    the unbiased variance into scratch buffers (momentum 1), and the
    biased variance is that times (n - 1) / n. The output keeps the
    input's dtype, the convs' compute dtype."""

    def __init__(self, features: int, device=None) -> None:
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, BN_EPS)
        batch_mean = torch.zeros_like(self.mean)
        batch_var = torch.ones_like(self.var)
        y = F.batch_norm(x, batch_mean, batch_var, self.scale, self.bias,
                         True, 1.0, BN_EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            biased = batch_var * ((n - 1) / n)
            self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * batch_mean)
            self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * biased)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with the ``[in, out]``
    kernel, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, device=None) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 with a projection shortcut where the
    shape changes (v1.5: the stride sits on the 3x3). The last BN's scale
    starts at zero (``convert.py``'s initialiser)."""

    def __init__(self, in_features: int, filters: int, strides: int,
                 dtype: torch.dtype, device=None) -> None:
        super().__init__()
        conv = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(in_features, filters, (1, 1), **conv)
        self.BatchNorm_0 = BatchNorm(filters, device)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **conv)
        self.BatchNorm_1 = BatchNorm(filters, device)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), **conv)
        self.BatchNorm_2 = BatchNorm(filters * 4, device)
        # flax builds the projection when the residual's shape differs
        # from the output's: other channels, or a stride that shrinks it.
        self.project = in_features != filters * 4 or strides != 1
        if self.project:
            self.Conv_3 = Conv(in_features, filters * 4, (1, 1), strides,
                               **conv)
            self.BatchNorm_3 = BatchNorm(filters * 4, device)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        residual = x
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        if self.project:
            residual = self.BatchNorm_3(self.Conv_3(residual), train)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """``ResNet(stage_sizes, num_classes, width, dtype, stem)``: flax's
    module with the same arguments (``dtype`` a torch dtype, default
    bf16), on ``device`` (default the card). ``forward(x, train=True)``
    takes NHWC images ``[B, H, W, 3]`` of any float or integer dtype and
    returns f32 logits ``[B, num_classes]``.

    ``stem="conv7"``: the 7x7 stride-2 stem conv; ``"s2d"``: the same
    function as a 4x4 stride-1 conv over space-to-depth(2) input
    (``stem_kernel_to_s2d`` shows the two agree).

    A block builds its projection where its input's channels or size
    differ from its output's: flax decides by the traced shapes, which in
    this architecture is the first block of each stage."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, dtype: torch.dtype = torch.bfloat16,
                 stem: str = "conv7", device=None) -> None:
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}: use 'conv7' or 's2d'")
        device = resolve_device(device)
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.num_classes, self.width = num_classes, width
        self.dtype, self.stem, self.device = dtype, stem, device
        conv = dict(dtype=dtype, device=device)
        if stem == "s2d":
            self.stem_s2d = Conv(12, width, (4, 4), 1, ((2, 1), (2, 1)),
                                 **conv)
        else:
            self.Conv_0 = Conv(3, width, (7, 7), 2, ((3, 3), (3, 3)), **conv)
        self.BatchNorm_0 = BatchNorm(width, device)
        blocks, features = [], width
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                strides = 2 if i > 0 and j == 0 else 1
                blocks.append(BottleneckBlock(features, width * 2**i,
                                              strides, **conv))
                features = width * 2**i * 4
        for k, block in enumerate(blocks):
            setattr(self, f"BottleneckBlock_{k}", block)
        self.n_blocks = len(blocks)
        self.Dense_0 = Dense(features, num_classes, torch.float32, device)

    def shape_fields(self) -> dict:
        """What fixes the variable tree's shapes: a checkpoint manifest's
        record of the model."""
        return {"model": "ResNet", "stage_sizes": list(self.stage_sizes),
                "num_classes": self.num_classes, "width": self.width,
                "stem": self.stem}

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = self.stem_s2d(to_nchw(space_to_depth(x, 2)))
        else:
            x = self.Conv_0(to_nchw(x))
        x = F.relu(self.BatchNorm_0(x, train))
        x = F.max_pool2d(x, 3, 2, 1)
        for k in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{k}")(x, train)
        x = x.mean(dim=(2, 3))
        # Classifier head in f32 for a stable softmax.
        return self.Dense_0(x.float())


def resnet50(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             stem: str = "conv7", device=None) -> ResNet:
    return ResNet((3, 4, 6, 3), num_classes, dtype=dtype, stem=stem,
                  device=device)


def resnet18(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
             device=None) -> ResNet:
    """Smaller variant for tests (still bottleneck blocks)."""
    return ResNet((2, 2, 2, 2), num_classes, dtype=dtype, device=device)
