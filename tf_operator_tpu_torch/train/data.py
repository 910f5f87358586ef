"""Synthetic datasets, deterministic and learnable: the port's own copies
of ``tf_operator_tpu/train/data.py``'s ``synthetic_mnist`` and
``synthetic_imagenet``, with the same numpy generators and seeds, so a
seed gives the JAX package's batches. Batches are host numpy arrays; the
train step moves them to its model's device. Nothing is downloaded.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_mnist(
    batch_size: int, seed: int = 0, flat: bool = False, noise: float = 1.0
) -> Iterator[dict[str, np.ndarray]]:
    """28x28x1 images drawn as class template + gaussian noise: a learnable
    10-way classification task. The templates come from seed 1234."""
    rng = np.random.default_rng(seed)
    templates = (
        np.random.default_rng(1234).normal(size=(10, 28, 28, 1)).astype(np.float32)
    )
    while True:
        y = rng.integers(0, 10, size=(batch_size,)).astype(np.int32)
        x = templates[y] + noise * rng.normal(size=(batch_size, 28, 28, 1)).astype(
            np.float32
        )
        yield {"image": x.reshape(batch_size, -1) if flat else x, "label": y}


def synthetic_imagenet(
    batch_size: int, image_size: int = 224, num_classes: int = 1000, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """ImageNet-shaped batches: f32 normal images, uniform labels."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.normal(size=(batch_size, image_size, image_size, 3)).astype(np.float32)
        y = rng.integers(0, num_classes, size=(batch_size,)).astype(np.int32)
        yield {"image": x, "label": y}
