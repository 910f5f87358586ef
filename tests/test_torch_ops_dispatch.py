"""The attention dispatch (tf_operator_tpu_torch/ops/__init__.py
``attention_kernel`` and ``attention(use_flash=)``, and
parallel/ulysses.py through it) held against JAX's
(tf_operator_tpu/ops/__init__.py) on the CPU.

- ``attention_kernel(..., device="cuda")`` against JAX's
  ``attention_kernel`` with ``tf_operator_tpu.ops.on_tpu_backend``
  patched to answer True (JAX on a TPU): over a table of lengths, head
  dims, dtypes and masks, under each value of ``TPU_OPERATOR_ATTN`` (unset,
  ``xla``, ``flash``, in any case and spacing), the answers that apply to
  the card are JAX's: the switch at ``xla`` answers ``"reference"`` where
  JAX answers ``"xla"``, and wherever JAX answers ``"pallas-flash"`` the
  port answers ``"cuda-flash"``. JAX's TPU tiling does not carry over:
  elsewhere (a length Mosaic's block rule does not tile, causal attention
  over unequal lengths) the port still answers its kernels, which take
  any length and raise outside their geometry; a typo raises JAX's
  ``ValueError`` in both. On the CPU the answer is the kernels' plain
  versions where ``flash_supported`` takes the shapes.
- ``attention(use_flash=None/True/False)`` under each switch value takes
  the branch the rule names, and its output is within the flash
  tolerance (tests/test_torch_flash_attention.py's ``FWD_TOL``) of JAX's
  ``attention`` with the same arguments and switch.
- ``ulysses_attention`` over 2 gloo ranks (``{"sp": 2}``) under each
  switch and ``use_flash``: the branch each rank took and its output
  block against JAX's ``ulysses_attention`` on 2 virtual devices, within
  ``FWD_TOL``; a typo raises on every rank.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_dp import free_port, rank_env, run_processes
from test_torch_flash_attention import FWD_TOL
from test_torch_tp_train import _jax_mesh

torch.set_num_threads(1)

SWITCHES = ["", "xla", "flash", " FLASH ", "Xla"]
TYPO = "pallas"
# (tq, tk): every block size JAX's compiled rule takes or refuses, its
# single-block fallback (a multiple of 16 up to 512), its MAX_SEQ_LEN, and
# unequal lengths.
LENGTHS = [(8, 8), (16, 16), (24, 24), (32, 32), (48, 48), (100, 100),
           (128, 128), (200, 200), (256, 256), (384, 384), (437, 437),
           (512, 512), (528, 528), (640, 640), (1000, 1000), (1024, 1024),
           (8192, 8192), (1 << 20, 1 << 20), (1 << 21, 1 << 21),
           (128, 256), (256, 128), (64, 128), (32, 48)]
HEAD_DIMS = [16, 32, 48, 64, 128]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]
ANSWERS = {"pallas-flash": "cuda-flash", "xla": "reference"}


@pytest.fixture
def on_tpu(monkeypatch):
    """JAX's dispatch as it answers on a TPU (its module, not edited)."""
    import tf_operator_tpu.ops as jax_ops

    monkeypatch.setattr(jax_ops, "on_tpu_backend", lambda: True)
    return jax_ops


def _switch(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TPU_OPERATOR_ATTN", raising=False)
    else:
        monkeypatch.setenv("TPU_OPERATOR_ATTN", value)


@pytest.mark.parametrize("switch", [None] + SWITCHES)
def test_attention_kernel_on_the_card_keeps_jax_s_switch(
        monkeypatch, on_tpu, switch):
    from tf_operator_tpu_torch import ops

    _switch(monkeypatch, switch)
    xla = (switch or "").strip().lower() == "xla"
    seen = set()
    for tq, tk in LENGTHS:
        for dh in HEAD_DIMS:
            for dtype in DTYPES:
                for causal in (True, False):
                    want = on_tpu.attention_kernel(
                        tq, tk, dh, dtype.itemsize, causal=causal)
                    got = ops.attention_kernel(tq, tk, dh, dtype,
                                               causal=causal, device="cuda")
                    case = (tq, tk, dh, dtype, causal)
                    if xla or want == "pallas-flash":
                        assert got == ANSWERS[want], case
                    else:
                        # A TPU tiling fact: the card's kernels take it.
                        assert got == "cuda-flash", case
                    seen.add(want)
    # The table reaches both of JAX's answers (but the switch at xla).
    assert seen == ({"xla"} if xla else {"pallas-flash", "xla"})


def test_a_typo_in_the_switch_raises_jax_s_error(monkeypatch, on_tpu):
    from tf_operator_tpu_torch import ops

    _switch(monkeypatch, f" {TYPO.upper()} ")
    with pytest.raises(ValueError) as jax_err:
        on_tpu.attention_kernel(128, 128, 64, 2)
    with pytest.raises(ValueError) as port_err:
        ops.attention_kernel(128, 128, 64, torch.bfloat16, device="cuda")
    assert str(port_err.value) == str(jax_err.value)
    q = torch.zeros((1, 16, 2, 32))
    with pytest.raises(ValueError, match="TPU_OPERATOR_ATTN='pallas'"):
        ops.attention(q, q, q)


def test_head_dim_16_answers_the_kernel_as_jax_does(monkeypatch, on_tpu):
    """``dist_lm --d-model 64`` (4 heads of 16) at its sequence of 128:
    JAX's rule ignores the head dim and answers its kernel on a TPU, so
    the port answers its kernels on the card, which do not take Dh 16:
    the call goes to ``flash_attention``, which raises there (ROADMAP:
    not run on the card)."""
    from tf_operator_tpu_torch import ops
    from tf_operator_tpu_torch.ops import flash_attention as fa

    _switch(monkeypatch, None)
    assert on_tpu.attention_kernel(128, 128, 16, 4) == "pallas-flash"
    assert ops.attention_kernel(128, 128, 16, torch.float32,
                                device="cuda") == "cuda-flash"
    assert not fa.flash_supported(128, 128, 16, torch.float32, causal=True)
    assert ops.attention_kernel(128, 128, 16, torch.float32,
                                device="cpu") == "reference"
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(fa, "reference_attention",
                        lambda *a, **kw: calls.append("reference"))

    class _OnCard:
        """The attributes the dispatch reads, of a tensor on the card."""
        shape, dtype, device = (2, 128, 4, 16), torch.float32, "cuda"

    x = _OnCard()
    ops.attention(x, x, x)
    _switch(monkeypatch, "xla")
    ops.attention(x, x, x)
    assert calls == ["flash", "reference"]


def test_untiled_and_unequal_lengths_go_to_the_kernels_on_the_card(
        monkeypatch, on_tpu):
    """Where JAX's dispatch sends a TPU to XLA for want of a Mosaic tiling
    (T = 437) or for causal attention over unequal lengths, the port's
    dispatch still calls the kernels on the card: ``flash_attention``
    takes any length and refuses causal tq != tk itself, so nothing moves
    quietly to the plain path. Only the switch at ``xla`` or
    ``use_flash=False`` does."""
    from tf_operator_tpu_torch import ops
    from tf_operator_tpu_torch.ops import flash_attention as fa

    _switch(monkeypatch, None)
    assert on_tpu.attention_kernel(437, 437, 64, 2) == "xla"
    assert on_tpu.attention_kernel(32, 64, 64, 2) == "xla"
    calls = []
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(fa, "reference_attention",
                        lambda *a, **kw: calls.append("reference"))

    class _OnCard:
        """The attributes the dispatch reads, of a tensor on the card."""
        dtype, device = torch.bfloat16, "cuda"

        def __init__(self, t):
            self.shape = (1, t, 2, 64)

    for tq, tk in ((437, 437), (32, 64)):
        q, kv = _OnCard(tq), _OnCard(tk)
        ops.attention(q, kv, kv)
        ops.attention(q, kv, kv, use_flash=True)
        ops.attention(q, kv, kv, use_flash=False)
    _switch(monkeypatch, "xla")
    ops.attention(q, kv, kv)
    assert calls == ["flash", "flash", "reference"] * 2 + ["reference"]
    monkeypatch.undo()
    q, kv = torch.zeros((1, 32, 2, 64)), torch.zeros((1, 64, 2, 64))
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention(q, kv, kv)


@pytest.mark.parametrize("switch", [None, "xla", "flash"])
def test_attention_kernel_on_the_cpu(monkeypatch, switch):
    """The CPU keeps its rule: the plain versions where the kernels would
    take the shapes, the reference elsewhere; the switch at xla forces
    the reference."""
    from tf_operator_tpu_torch import ops
    from tf_operator_tpu_torch.ops import flash_attention as fa

    _switch(monkeypatch, switch)
    for tq, tk in LENGTHS[:16] + LENGTHS[-4:]:
        for dh in HEAD_DIMS:
            for causal in (True, False):
                got = ops.attention_kernel(tq, tk, dh, torch.float32,
                                           causal=causal, device="cpu")
                plain = fa.flash_supported(tq, tk, dh, torch.float32,
                                           causal=causal)
                want = ("flash-plain" if plain and switch != "xla"
                        else "reference")
                assert got == want, (tq, tk, dh, causal)


def _spy(monkeypatch, calls):
    from tf_operator_tpu_torch.ops import flash_attention as fa

    flash, plain = fa.flash_attention, fa.reference_attention
    monkeypatch.setattr(fa, "flash_attention", lambda *a, **kw: (
        calls.append("flash-plain"), flash(*a, **kw))[1])
    monkeypatch.setattr(fa, "reference_attention", lambda *a, **kw: (
        calls.append("reference"), plain(*a, **kw))[1])


def _branch(switch, use_flash):
    """The branch the port's CPU dispatch takes at Dh 32 and T 16."""
    if use_flash is False or (use_flash is None and switch == "xla"):
        return "reference"
    return "flash-plain"


@pytest.mark.parametrize("use_flash", [None, True, False])
@pytest.mark.parametrize("switch", [None, "xla", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_use_flash_matches_jax(monkeypatch, switch, use_flash,
                                         causal):
    import jax.numpy as jnp

    import tf_operator_tpu.ops as jax_ops
    from tf_operator_tpu_torch import ops

    _switch(monkeypatch, switch)
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((1, 16, 2, 32)).astype(np.float32)
               for _ in range(3))
    calls = []
    _spy(monkeypatch, calls)
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                        causal=causal, use_flash=use_flash)
    assert calls == [_branch(switch, use_flash)]
    want = jax_ops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=causal, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL,
                               rtol=FWD_TOL)


# -- Ulysses over 2 gloo ranks ----------------------------------------------

ULYSSES_SHAPE = (2, 16, 4, 32)  # [B, T, H, Dh]: 2 heads a rank at sp 2
ULYSSES_CASES = [(s, u) for s in (None, "xla", "flash")
                 for u in (None, True, False)] + [(TYPO, None)]


def ulysses_rank(rank, world, p):
    """Every (switch, use_flash) case on this rank's sequence block: the
    branches its dispatch took and its output block, or the error."""
    from tf_operator_tpu_torch.ops import flash_attention as fa
    from tf_operator_tpu_torch.parallel.mesh import create_mesh
    from tf_operator_tpu_torch.parallel.sharding import TensorParallel
    from tf_operator_tpu_torch.parallel.ulysses import ulysses_attention

    axis = TensorParallel(create_mesh({"sp": 2}, device="cpu"), "sp")
    t = ULYSSES_SHAPE[1] // 2
    q, k, v = (torch.from_numpy(x[:, rank * t:(rank + 1) * t])
               for x in p["qkv"])
    flash, plain = fa.flash_attention, fa.reference_attention
    out = {}
    for switch, use_flash in ULYSSES_CASES:
        calls = []
        fa.flash_attention = lambda *a, **kw: (
            calls.append("flash-plain"), flash(*a, **kw))[1]
        fa.reference_attention = lambda *a, **kw: (
            calls.append("reference"), plain(*a, **kw))[1]
        if switch is None:
            os.environ.pop("TPU_OPERATOR_ATTN", None)
        else:
            os.environ["TPU_OPERATOR_ATTN"] = switch
        try:
            o = ulysses_attention(q, k, v, axis, use_flash=use_flash)
            out[(switch, use_flash)] = (calls, o.numpy())
        except ValueError as e:
            out[(switch, use_flash)] = (calls, str(e))
        finally:
            fa.flash_attention, fa.reference_attention = flash, plain
    return out


def _jax_ulysses(qkv, switch, use_flash):
    import jax.numpy as jnp

    from tf_operator_tpu.parallel.ulysses import ulysses_attention

    env = os.environ.get("TPU_OPERATOR_ATTN")
    if switch is None:
        os.environ.pop("TPU_OPERATOR_ATTN", None)
    else:
        os.environ["TPU_OPERATOR_ATTN"] = switch
    try:
        return np.asarray(ulysses_attention(
            *(jnp.asarray(x) for x in qkv), _jax_mesh({"sp": 2}),
            use_flash=use_flash))
    finally:
        if env is None:
            os.environ.pop("TPU_OPERATOR_ATTN", None)
        else:
            os.environ["TPU_OPERATOR_ATTN"] = env


_ULYSSES: dict = {}


def ulysses_results():
    """(the inputs, the 2 ranks' results), computed once."""
    if not _ULYSSES:
        rng = np.random.default_rng(12)
        qkv = [rng.standard_normal(ULYSSES_SHAPE).astype(np.float32)
               for _ in range(3)]
        port = free_port()
        _ULYSSES["all"] = qkv, run_processes(
            "test_torch_ops_dispatch", "ulysses_rank",
            [rank_env(r, 2, port) for r in range(2)], {"qkv": qkv})
    return _ULYSSES["all"]


@pytest.mark.parametrize("switch,use_flash", ULYSSES_CASES[:-1])
def test_ulysses_honours_the_switch_and_use_flash(switch, use_flash):
    qkv, ranks = ulysses_results()
    want = _jax_ulysses(qkv, switch, use_flash)
    t = ULYSSES_SHAPE[1] // 2
    for rank, got in enumerate(ranks):
        calls, out = got[(switch, use_flash)]
        assert calls == [_branch(switch, use_flash)]
        np.testing.assert_allclose(out, want[:, rank * t:(rank + 1) * t],
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_ulysses_raises_on_a_typo_in_the_switch():
    _, ranks = ulysses_results()
    for got in ranks:
        calls, err = got[(TYPO, None)]
        assert calls == [] and err == (
            f"TPU_OPERATOR_ATTN={TYPO!r}: expected 'xla' or 'flash'")
