"""Device-resident input: the raw uint8 records live on the card, and
sampling and augmentation run there too.

Counterpart of ``tf_operator_tpu/train/device_input.py``. The record set
goes to the device once; each step's input is then one gather + random
crop + random horizontal flip + normalise, with no host work and no
transfer. Two sampling contracts: i.i.d. with replacement
(``make_resident_sampler``, stateless, replayable from a key) and exact
per-epoch permutation coverage (``make_resident_epoch_sampler``, whose
permutation and cursor are explicit state the caller carries).

Every draw (indices, crop offsets, flips, the epoch permutation) comes
from the port's threefry (``random.py``) in JAX's split order, so a key
gives bitwise JAX's batch. Where JAX scans the fused loop on the device,
the port runs a Python loop that carries the key and the sampler state
(a CUDA graph of it is A5's graph).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from tf_operator_tpu_torch.random import bernoulli, permutation, randint, split


def load_records_numpy(
    path: str, rec_bytes: int, record_size: int
) -> tuple[np.ndarray, np.ndarray]:
    """Read a record file (image bytes + 1 trailing label byte per record,
    the layout of ``bench.py``'s ``ensure_bench_records``) into
    ([N, R, R, 3] uint8 images, [N] int32 labels), ready for one copy to
    the device."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size % rec_bytes:
        raise ValueError(
            f"{path}: size {raw.size} is not a multiple of rec_bytes "
            f"{rec_bytes}"
        )
    n = raw.size // rec_bytes
    img_bytes = record_size * record_size * 3
    if img_bytes + 1 != rec_bytes:
        raise ValueError(
            f"rec_bytes {rec_bytes} != {record_size}^2*3 + 1 label byte"
        )
    recs = raw.reshape(n, rec_bytes)
    images = recs[:, :img_bytes].reshape(n, record_size, record_size, 3)
    labels = recs[:, img_bytes].astype(np.int32)
    return images, labels


def _make_augment(images: torch.Tensor, labels: torch.Tensor,
                  image_size: int, num_classes: int):
    """augment(idx, k_oy, k_ox, k_flip) -> batch dict: the ONE gather +
    random crop + random hflip + normalise block both samplers share.
    The crop and the flip are one gather: row ``oy + i`` and column
    ``ox + j``, or ``ox + S - 1 - j`` where the flip is on, of record
    ``idx``."""
    r = images.shape[1]
    margin = r - image_size
    if margin < 0:
        raise ValueError(f"records {r}^2 smaller than crop {image_size}^2")
    ramp = torch.arange(image_size, device=images.device)

    def augment(idx, k_oy, k_ox, k_flip):
        batch = idx.shape[0]
        oy = randint(k_oy, (batch,), 0, margin + 1)
        ox = randint(k_ox, (batch,), 0, margin + 1)
        flip = bernoulli(k_flip, 0.5, (batch,))
        rows = oy[:, None] + ramp
        cols = ox[:, None] + torch.where(flip[:, None],
                                         image_size - 1 - ramp, ramp)
        crops = images[idx[:, None, None], rows[:, :, None],
                       cols[:, None, :]]
        img = (crops.to(torch.bfloat16) - 127.5) / 127.5
        return {"image": img, "label": labels[idx] % num_classes}

    return augment


def make_resident_sampler(images: torch.Tensor, labels: torch.Tensor,
                          batch: int, image_size: int,
                          num_classes: int = 1000) -> Callable:
    """sample_batch(key) -> {"image": bf16 normalised [B, S, S, 3],
    "label": [B]}: i.i.d. draws with replacement through the shared
    augment block, on the key's device.

    ``images``: [N, R, R, 3] uint8 on the device, ``labels``: [N]
    integers. R > image_size crops at random offsets in [0, R - S];
    R == image_size only flips."""
    n = images.shape[0]
    augment = _make_augment(images, labels, image_size, num_classes)

    def sample_batch(key):
        k_idx, k_oy, k_ox, k_flip = split(key, 4)
        idx = randint(k_idx, (batch,), 0, n)
        return augment(idx, k_oy, k_ox, k_flip)

    return sample_batch


def make_resident_epoch_sampler(images: torch.Tensor, labels: torch.Tensor,
                                batch: int, image_size: int,
                                num_classes: int = 1000):
    """The epoch-shuffled sampler: every record once an epoch, in a
    permutation drawn on the device at each epoch's start.

    Returns (sample_batch, state0): ``sample_batch(key, state) ->
    (batch_dict, state)`` where state = (perm [N], cursor int). The
    cursor starts AT N, so the first call draws the first permutation
    from its key. Requires N % batch == 0. The crop and flip draws come
    from each call's key."""
    n = images.shape[0]
    if n % batch:
        raise ValueError(
            f"records ({n}) must be divisible by batch ({batch}) for "
            "exact epoch coverage"
        )
    augment = _make_augment(images, labels, image_size, num_classes)

    def sample_batch(key, state):
        perm, cursor = state
        k_perm, k_oy, k_ox, k_flip = split(key, 4)
        # Epoch boundary: reshuffle and restart (the cursor only ever
        # grows by batch, so the test is exact).
        if cursor >= n:
            perm, cursor = permutation(k_perm, n), 0
        idx = perm[cursor:cursor + batch]
        return augment(idx, k_oy, k_ox, k_flip), (perm, cursor + batch)

    state0 = (torch.arange(n, device=images.device), n)
    return sample_batch, state0


def make_resident_epoch_train_loop(step: Callable, sample_batch: Callable,
                                   n_steps: int) -> Callable:
    """The fused (sample on the device -> train step) loop, stateful form:
    fused(state, key, sampler_state) -> (state, last_metrics, key,
    sampler_state). Each step splits the key (carry, sub), samples from
    sub and trains, so consecutive calls continue both streams exactly as
    JAX's scan does."""

    def fused(state, key, sstate):
        metrics = None
        for _ in range(n_steps):
            key, sub = split(key)
            batch, sstate = sample_batch(sub, sstate)
            state, metrics = step(state, batch)
        return state, metrics, key, sstate

    return fused


def make_resident_train_loop(step: Callable, sample_batch: Callable,
                             n_steps: int) -> Callable:
    """Stateless-sampler form: fused(state, key) -> (state, last_metrics,
    next_key), for ``make_resident_sampler``'s sample_batch(key); the
    stateful loop with unit sampler state."""

    def stateful_sample(key, sstate):
        return sample_batch(key), sstate

    inner = make_resident_epoch_train_loop(step, stateful_sample, n_steps)

    def fused(state, key):
        state, metrics, key, _ = inner(state, key, ())
        return state, metrics, key

    return fused
