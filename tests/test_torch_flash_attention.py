"""The port's flash attention (tf_operator_tpu_torch/ops/flash_attention.py)
held against the JAX package's Pallas kernels in interpret mode on the
CPU, in f32: the forward and, through the port's autograd.Function, the
gradients, causal and full, with tq != tk both ways and lengths that are
no multiple of the kernels' 64-row tile. On the CPU the port runs the
plain versions of its kernels through the same forward/backward
structure as on the card.

Tolerances are the JAX package's own for these kernels
(tests/test_ops.py): 2e-5 for the forward, 2e-4 for gradients, which sum
over every query row in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_operator_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention,
)
from tf_operator_tpu.parallel.ring_attention import (
    reference_attention as jax_reference_attention,
)
from tf_operator_tpu_torch import ops
from tf_operator_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

FWD_TOL, GRAD_TOL = 2e-5, 2e-4

# (tq, tk, causal, heads, head_dim, JAX block); JAX needs a block that
# divides both lengths, the port takes any length.
CASES = [
    (40, 40, True, 2, 16, 8),
    (64, 64, False, 2, 8, 16),
    (32, 64, False, 2, 16, 32),
    (64, 32, False, 2, 16, 32),
    (72, 72, True, 1, 32, 8),
]


def _qkv(rng, b, tq, tk, h, d):
    q = rng.standard_normal((b, tq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    v = rng.standard_normal((b, tk, h, d), dtype=np.float32)
    return q, k, v


def _ids(case):
    tq, tk, causal, h, d, _ = case
    return f"{'causal' if causal else 'full'}-{tq}x{tk}-h{h}d{d}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_forward_matches_jax_interpret(case):
    tq, tk, causal, h, d, block = case
    q, k, v = _qkv(np.random.default_rng(0), 2, tq, tk, h, d)
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block=block, interpret=True)
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grads_match_jax_interpret(case):
    tq, tk, causal, h, d, block = case
    q, k, v = _qkv(np.random.default_rng(1), 1, tq, tk, h, d)

    def jax_loss(q, k, v):
        o = jax_flash_attention(q, k, v, causal=causal, block=block,
                                interpret=True)
        return (o * o).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq_, tk_, tv_ = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(tq_, tk_, tv_, causal=causal)
    (o * o).sum().backward()
    for got, ref, name in zip((tq_.grad, tk_.grad, tv_.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(np.random.default_rng(2), 2, 24, 24, 2, 8)
    want = jax_reference_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    got = fa.reference_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_from_stats_matches_autograd_of_the_oracle(causal):
    """flash_bwd_from_stats, fed the forward's lse and delta =
    rowsum(dO * O), gives the gradients autograd takes through
    reference_attention."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 2, 40, 40, 2, 16))
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32))
    scale = 16 ** -0.5
    o, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    got = fa.flash_bwd_from_stats(q, k, v, do, lse, delta, causal, scale)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    fa.reference_attention(*leaves, causal=causal).backward(do)
    for g, leaf, name in zip(got, leaves, "qkv"):
        torch.testing.assert_close(g, leaf.grad, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_forward_lse_is_the_row_logsumexp(causal):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 30, 30, 2, 8))
    scale = 8 ** -0.5
    _, lse = fa.flash_fwd_reference(q, k, v, causal, scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(30, 30, dtype=torch.bool).triu(1),
                          -float("inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=FWD_TOL,
                               rtol=FWD_TOL)


def test_bf16_forward_stays_near_the_f32_oracle():
    """The plain forward casts P to v's dtype for P.V, as the kernel
    does: in bf16 it stays within bf16 rounding (8 bits) of f32."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 48, 48, 2, 32))
    want = fa.reference_attention(q, k, v, causal=True)
    got = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             causal=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=0)


def test_flash_supported_rule():
    assert fa.flash_supported(8192, 8192, 64, torch.bfloat16, causal=True)
    assert fa.flash_supported(1000, 1000, 32, torch.float32, causal=True)
    assert fa.flash_supported(512, 1024, 128, torch.float32, causal=False)
    assert not fa.flash_supported(512, 1024, 64, torch.float32, causal=True)
    assert not fa.flash_supported(64, 64, 48, torch.float32, causal=True)
    assert not fa.flash_supported(64, 64, 64, torch.float16, causal=True)
    assert not fa.flash_supported(0, 0, 64, torch.float32, causal=False)


def test_attention_dispatch(monkeypatch):
    """On the CPU, ops.attention runs flash where flash_supported says so
    and the plain oracle elsewhere."""
    calls = []
    flash, plain = fa.flash_attention, fa.reference_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or
                        flash(*a, **kw))
    monkeypatch.setattr(fa, "reference_attention",
                        lambda *a, **kw: calls.append("plain") or
                        plain(*a, **kw))
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, 1, 16, 16, 2, 32))
    torch.testing.assert_close(ops.attention(q, k, v), plain(q, k, v),
                               atol=FWD_TOL, rtol=FWD_TOL)
    assert calls == ["flash"]
    q48, k48, v48 = (torch.from_numpy(x) for x in _qkv(rng, 1, 16, 16, 2, 48))
    ops.attention(q48, k48, v48)
    assert calls == ["flash", "plain"]


def test_attention_on_a_cuda_tensor_never_takes_the_plain_branch(
        monkeypatch):
    """A CUDA tensor goes to flash_attention whatever its geometry (which
    launches the kernels or raises); reference_attention is not called."""
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(fa, "reference_attention",
                        lambda *a, **kw: calls.append("plain"))

    class _OnCard:
        """The attributes the dispatch reads, of a tensor on the card."""

        def __init__(self, shape):
            self.shape, self.dtype = shape, torch.float16
            self.device = torch.device("cuda")

    for shape in ((1, 16, 2, 48), (1, 16, 2, 64)):
        x = _OnCard(shape)
        ops.attention(x, x, x, causal=True)
    assert calls == ["flash", "flash"]


def test_flash_rejects_causal_with_unequal_lengths():
    q, k, v = (torch.from_numpy(x)
               for x in _qkv(np.random.default_rng(7), 1, 8, 16, 1, 32))
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention(q, k, v, causal=True)
