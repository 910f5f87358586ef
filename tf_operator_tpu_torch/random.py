"""The pieces of ``jax.random`` the reference samples through, in PyTorch.

JAX's default PRNG as the reference runs it (JAX 0.9.0:
``jax_default_prng_impl=threefry2x32``, ``jax_threefry_partitionable=True``,
``jax_enable_x64=False``, ``jax_high_dynamic_range_gumbel=False``), from
``jax/_src/prng.py`` and ``jax/_src/random.py``:

- ``threefry2x32``: the Threefry-2x32 hash, 20 rounds, with the rotations
  and key schedule of ``_threefry2x32_lowering``;
- ``PRNGKey``: ``threefry_seed`` after ``random_seed``'s cast of the seed
  to a 32-bit integer (x64 off): ``[0, seed & 0xFFFFFFFF]``, so negative
  and 64-bit seeds keep their low 32 bits;
- ``split``: ``_threefry_split_foldlike``, the hash of each output
  index's (hi, lo) words (``iota_2x32_shape``);
- ``fold_in``: the hash of the counter pair ``(0, data)``;
- ``random_bits``: ``_threefry_random_bits_partitionable`` at 32 bits,
  ``bits1 ^ bits2`` of the hash of each flat index's (hi, lo) words;
- ``uniform``: ``_uniform``'s mantissa trick for float32;
- ``gumbel``: ``_gumbel`` in mode ``"low"``;
- ``categorical``: the Gumbel-max of ``random.categorical``;
- ``randint``: ``_randint`` at 32 bits, two ``random_bits`` draws from a
  split key folded into the span with uint32 ``rem``/``mul`` and
  wraparound;
- ``bernoulli``: ``_bernoulli`` in mode ``"low"``, ``uniform < p``;
- ``permutation``: ``_shuffle`` of ``arange(n)``, rounds of a stable sort
  on fresh 32-bit keys.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words.
Every word is carried in int64 and masked to 32 bits after each add and
rotate, so the integer results are bitwise the same on the CPU and on
CUDA (torch's uint32 lacks shifts and wrapping adds there). Each
function runs on its key's device; keys with leading dimensions give
one independent draw of ``shape`` per key, as ``jax.vmap`` over keys
would.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tf_operator_tpu_torch import resolve_device

MASK = 0xFFFFFFFF
# The Threefry-2x32 rotation constants, alternating every 4 rounds, and
# the key-schedule parity word.
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
# float32's smallest normal number: gumbel's lower bound for uniform.
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key words
    ``(k0, k1)``: int64 tensors of uint32 values that broadcast together.
    Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed & 0xFFFFFFFF]`` (with x64
    off JAX casts the seed to 32 bits first, so the high word is 0)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=resolve_device(device))


def _key_words(key: torch.Tensor, ndim: int):
    """A key's two words, shaped to broadcast over ``ndim`` trailing
    dimensions after its leading ones."""
    lead = key.shape[:-1]
    tail = (1,) * ndim
    return key[..., 0].reshape(*lead, *tail), key[..., 1].reshape(*lead, *tail)


def _counters(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``iota_2x32_shape``: the (hi, lo) words of each element's flat
    index in ``shape``."""
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & MASK).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` new keys."""
    hi, lo = _counters((num,), key.device)
    k0, k1 = _key_words(key, 1)
    return torch.stack(threefry2x32(k0, k1, hi, lo), dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a data word in [0, 2**32)."""
    x0 = torch.zeros((), dtype=torch.int64, device=key.device)
    x1 = torch.full((), int(data) & MASK, dtype=torch.int64,
                    device=key.device)
    return torch.stack(threefry2x32(key[..., 0], key[..., 1], x0, x1), -1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` at 32 bits: ``[..., *shape]`` int64
    words in [0, 2**32)."""
    shape = tuple(shape)
    hi, lo = _counters(shape, key.device)
    y0, y1 = threefry2x32(*_key_words(key, len(shape)), hi, lo)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    1.0's exponent, minus 1, scaled to [minval, maxval) and floored at
    minval. The float view is an int32 bitcast; the bounds are rounded to
    float32 first, as JAX converts them, and their difference is taken in
    float32."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    # Python floats that float32 holds exactly: no copy to the device.
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return (floats * span + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode ``"low"`` (JAX's default):
    ``-log(-log(u))`` for ``u`` uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of ``gumbel(key, logits.shape) + logits``. The noise is drawn
    over the WHOLE shape, so a batch of 4 rows is not four draws of one
    row. Returns int64 indices."""
    return (gumbel(key, logits.shape) + logits).argmax(-1)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds
    (JAX's default integer dtype with x64 off): int64 values in
    [minval, maxval), or ``minval`` everywhere when ``maxval <= minval``.
    ``hi % span * (2**32 % span) + lo % span``, all in uint32 with
    wraparound, then ``% span``: the slight modulo bias is JAX's too."""
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    k_hi, k_lo = split(key)
    hi, lo = random_bits(k_hi, shape), random_bits(k_lo, shape)
    # 2**32 % span as JAX computes it: (2**16 % span)**2 % span in uint32.
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    offset = ((hi % span) * mult + lo % span) & MASK
    return minval + offset % span


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` in mode ``"low"``: float32
    ``uniform(key, shape) < p``. Returns a bool tensor."""
    return uniform(key, shape) < float(np.float32(p))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` shuffled by
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds (one for n <= 1625), each
    splitting the key, drawing 32-bit sort keys and sorting stably by
    them. int64 values on the key's device."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x
