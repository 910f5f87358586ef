"""``fuse_steps`` (tf_operator_tpu_torch/train/steps.py) against JAX's
(tf_operator_tpu/train/steps.py), as tests/test_training.py holds JAX's
against its own sequential steps, on the CPU in f32.

- The MNIST classifier step (SGD with momentum) fused 3 times on one
  batch: the state and the last step's metrics bitwise the port's 3
  sequential steps, the step count 3, and within ``LOSS_TOL`` (losses)
  and ``LEAF_RTOL`` (leaves) of JAX's ``fuse_steps`` of its step from the
  same variables.
- The LM step (AdamW) fused with ``scan_batches=True`` over 3 stacked
  batches: bitwise the port's steps over the batches in turn, and within
  the same tolerances (plus Adam's noise bound) of JAX's fused call.
- ``scan_batches=True`` with another leading dim raises JAX's
  ``ValueError``, word for word.
- ``donate=False`` raises: the port's state is updated in place.
"""

import numpy as np
import pytest
import torch

from test_torch_a8i import LM_KW, LR, lm_tokens
from test_torch_dp import LEAF_RTOL, LOSS_TOL, _assert_leaves_close, _flat
from test_torch_tp_train import _jax_mesh, seeded_tree

torch.set_num_threads(1)

STEPS = 3


def _mnist_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(16, 28, 28, 1)).astype(np.float32),
            "label": rng.integers(0, 10, size=(16,)).astype(np.int32)}


def _mnist_variables():
    import jax

    from tf_operator_tpu.models.mnist import MnistCNN as JaxMnist

    model = JaxMnist(dtype=jax.numpy.float32)
    v = model.init(jax.random.PRNGKey(0), np.zeros((8, 28, 28, 1),
                                                   np.float32), train=True)
    return model, jax.tree.map(np.asarray, v)


def _port_mnist(variables):
    from tf_operator_tpu_torch.models import convert
    from tf_operator_tpu_torch.models.mnist import MnistCNN
    from tf_operator_tpu_torch.train import steps

    model = convert.load_variables(
        MnistCNN(dtype=torch.float32, device="cpu"), variables)
    tx = steps.sgd_momentum(0.05)
    step = steps.make_classifier_train_step(model, tx, has_batch_stats=False)
    return model, steps.TrainState.create(model, tx), step


def _export(model):
    from tf_operator_tpu_torch.models import convert

    return convert.export_variables(model)["params"]


def test_fused_classifier_steps_match_sequential_and_jax():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.parallel.sharding import replicate
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.train.steps import fuse_steps

    jax_model, variables = _mnist_variables()
    batch = _mnist_batch()

    seq_model, seq, step = _port_mnist(variables)
    for _ in range(STEPS):
        seq, m_seq = step(seq, batch)
    fused_model, fused, step = _port_mnist(variables)
    fused, m_fused = fuse_steps(step, STEPS)(fused, batch)

    assert fused.step == seq.step == STEPS
    assert isinstance(m_fused["loss"], torch.Tensor)
    for key in ("loss", "accuracy"):
        assert torch.equal(m_fused[key], m_seq[key]), key
    got = _flat(_export(fused_model))
    for path, leaf in _flat(_export(seq_model)).items():
        assert np.array_equal(got[path], leaf), path

    mesh = _jax_mesh({"dp": 1})
    tx = jax_steps.sgd_momentum(0.05)
    jstep = jax_steps.make_classifier_train_step(
        jax_model, tx, mesh, has_batch_stats=False, donate=False)
    jstate = replicate(mesh, jax_steps.TrainState.create(
        variables["params"], tx))
    jstate, jm = jax_steps.fuse_steps(jstep, STEPS, donate=False)(
        jstate, jax.tree.map(jnp.asarray, batch))
    assert int(jstate.step) == STEPS
    np.testing.assert_allclose(float(m_fused["loss"]), float(jm["loss"]),
                               rtol=LOSS_TOL)
    _assert_leaves_close(_export(fused_model),
                         jax.tree.map(np.asarray, jstate.params), LEAF_RTOL)


def _port_lm(params):
    from tf_operator_tpu_torch.models.convert import load_params
    from tf_operator_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from tf_operator_tpu_torch.train import steps

    model = load_params(Transformer(TransformerConfig(
        dtype=torch.float32, **LM_KW), device="cpu"), params)
    tx = steps.adamw(LR)
    step = steps.make_lm_train_step(model, tx, xent_chunk=8)
    return model, steps.TrainState.create(model, tx), step


def test_fused_lm_steps_over_stacked_batches_match_sequential_and_jax():
    import jax
    import jax.numpy as jnp

    from tf_operator_tpu.models.transformer import (
        Transformer as JaxTransformer,
        TransformerConfig as JaxConfig,
    )
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.train.steps import fuse_steps

    params = seeded_tree(LM_KW, 80)
    batches = [lm_tokens(LM_KW, 81 + i) for i in range(STEPS)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    seq_model, seq, step = _port_lm(params)
    for b in batches:
        seq, m_seq = step(seq, b)
    fused_model, fused, step = _port_lm(params)
    fused, m_fused = fuse_steps(step, STEPS, scan_batches=True)(fused,
                                                                stacked)
    assert fused.step == seq.step == STEPS
    assert torch.equal(m_fused["loss"], m_seq["loss"])
    got = _flat(_export(fused_model))
    for path, leaf in _flat(_export(seq_model)).items():
        assert np.array_equal(got[path], leaf), path

    mesh = _jax_mesh({"dp": 1})
    model = JaxTransformer(JaxConfig(dtype=jnp.float32, **LM_KW))
    tx = jax_steps.adamw(LR)
    jstep = jax_steps.make_lm_train_step(model, tx, mesh, xent_chunk=8,
                                         donate=False)
    jfused = jax_steps.fuse_steps(jstep, STEPS, scan_batches=True,
                                  donate=False)
    jstate, jm = jfused(jax_steps.TrainState.create(params, tx),
                        jax.tree.map(jnp.asarray, stacked))
    np.testing.assert_allclose(float(m_fused["loss"]), float(jm["loss"]),
                               rtol=LOSS_TOL)
    _assert_leaves_close(_export(fused_model),
                         jax.tree.map(np.asarray, jstate.params), LEAF_RTOL,
                         lr_sum=STEPS * LR)


def test_scan_batches_with_another_leading_dim_raises_jax_s_error():
    from tf_operator_tpu.train import steps as jax_steps
    from tf_operator_tpu_torch.train.steps import fuse_steps

    batch = lm_tokens(LM_KW, 90)  # leading dim 8, not STEPS
    with pytest.raises(ValueError) as jax_err:
        jax_steps.fuse_steps(lambda s, b: (s, {}), STEPS, scan_batches=True,
                             donate=False)(np.zeros(()), batch)
    calls = []
    with pytest.raises(ValueError) as port_err:
        fuse_steps(lambda s, b: calls.append(b) or (s, {}), STEPS,
                   scan_batches=True)(None, batch)
    assert str(port_err.value) == str(jax_err.value)
    assert "leading dim" in str(port_err.value) and not calls


def test_donate_false_raises_since_the_state_is_updated_in_place():
    """JAX's ``donate=False`` keeps the state passed in intact; the port's
    steps update it in place, so the fused call gives back the state it
    was given, and ``donate=False`` raises rather than pretend."""
    from tf_operator_tpu_torch.train.steps import fuse_steps

    _, variables = _mnist_variables()
    _, state, step = _port_mnist(variables)
    with pytest.raises(ValueError, match="donate=False"):
        fuse_steps(step, STEPS, donate=False)
    out, _ = fuse_steps(step, 1)(state, _mnist_batch())
    assert out is state and state.step == 1
