"""The port's image classifiers (tf_operator_tpu_torch/models/resnet.py,
models/mnist.py, the classifier half of train/steps.py and of
models/convert.py, and train/checkpoint.py on a classifier) held against
the JAX package on the CPU in f32, on trees converted by
models/convert.py: ResNet logits in both stems, at two sizes, in training
mode (batch statistics, and the running statistics it leaves) and in
inference mode; the s2d stem's kernel embedding; ResNet-50's tree against
``jax.eval_shape``; MnistCNN's logits; three SGD-momentum and three LARS
steps (loss, accuracy, every param and batch_stats leaf) against JAX's
``make_classifier_train_step`` on a 1-device mesh; ``evaluate`` over a
ragged tail; LARS's zero-norm rule against optax; a checkpoint round trip
with batch_stats and momentum buffers.

Tolerances, all f32: logits within ``LOGIT_RTOL`` 1e-5 of the logits'
largest magnitude (measured ~2e-7: two frameworks' conv and reduction
orders); batch_stats after a forward within 1e-5 relative to each leaf's
largest magnitude; after 3 steps every leaf within ``LEAF_RTOL`` 1e-4 of
its largest magnitude (measured <= 1e-5) and losses within 1e-5 of
max(1, |loss|);
accuracies and eval counts exact. The s2d embedding is exact (bitwise
JAX's, and the two stems agree in float64 to 1e-12)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tf_operator_tpu.models.mnist import MnistCNN as JaxMnist
from tf_operator_tpu.models.resnet import ResNet as JaxResNet
from tf_operator_tpu.models.resnet import resnet50 as jax_resnet50
from tf_operator_tpu.models.resnet import (
    stem_kernel_to_s2d as jax_stem_kernel_to_s2d,
)
from tf_operator_tpu.parallel.mesh import create_mesh
from tf_operator_tpu.train import steps as jax_steps
from tf_operator_tpu_torch.models import convert, resnet
from tf_operator_tpu_torch.models.mnist import MnistCNN
from tf_operator_tpu_torch.parallel import mesh as port_mesh
from tf_operator_tpu_torch.train import checkpoint, steps
from tf_operator_tpu_torch.train.checkpoint import CheckpointManager

torch.set_num_threads(1)

LOGIT_RTOL, STATS_RTOL, LEAF_RTOL, LOSS_TOL = 1e-5, 1e-5, 1e-4, 1e-5
STAGES, WIDTH, CLASSES = (1, 1), 8, 10


def _mesh():
    return create_mesh({"dp": 1}, jax.devices("cpu")[:1])


def _jax_resnet(stem):
    return JaxResNet(stage_sizes=STAGES, width=WIDTH, num_classes=CLASSES,
                     dtype=jnp.float32, stem=stem)


def _port_resnet(stem):
    return resnet.ResNet(STAGES, CLASSES, WIDTH, torch.float32, stem,
                         device="cpu")


def _randomized(tree, rng):
    """Every leaf random (1-D leaves, scales and variances among them,
    in [0.5, 1.5)), so zero-initialised heads and scales test nothing
    away."""
    return jax.tree.map(
        lambda a: (rng.uniform(0.5, 1.5, a.shape) if a.ndim == 1
                   else rng.normal(size=a.shape) * 0.3).astype(np.float32),
        tree)


def _images(rng, b, hw, c=3):
    return rng.normal(size=(b, hw, hw, c)).astype(np.float32)


def _flat(tree):
    return {tuple(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_leaves_close(got, want, rtol):
    flat_got, flat_want = _flat(got), _flat(want)
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(flat_got[path] - w).max())
        assert err <= rtol * scale, (path, err, scale)


def _assert_logits_close(got, want):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= LOGIT_RTOL * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("hw", [16, 32])
@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet_logits_match_flax(stem, hw, train):
    rng = np.random.default_rng(hw)
    x = _images(rng, 4, hw)
    jm = _jax_resnet(stem)
    v = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), x)), rng)
    model = convert.load_variables(_port_resnet(stem), v)
    got = model(torch.from_numpy(x), train=train)
    if train:
        want, updates = jm.apply(v, x, train=True, mutable=["batch_stats"])
        _assert_leaves_close(
            convert.export_variables(model)["batch_stats"],
            updates["batch_stats"], STATS_RTOL)
    else:
        want = jm.apply(v, x, train=False)
        # Inference leaves the running statistics alone.
        _assert_leaves_close(convert.export_variables(model)["batch_stats"],
                             v["batch_stats"], 0.0)
    assert got.dtype == torch.float32
    _assert_logits_close(got, want)


def test_flax_same_padding_is_asymmetric_under_stride():
    """A 3x3 stride-2 "SAME" conv on an even input pads (0, 1): the
    port's Conv against flax's nn.Conv, and torch's padding=1 (1, 1) is
    not it."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    x = _images(rng, 1, 8, 2)
    conv = nn.Conv(4, (3, 3), strides=(2, 2), use_bias=False)
    v = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(0), x))
    want = np.asarray(conv.apply(v, x))
    port = resnet.Conv(2, 4, (3, 3), 2)
    port.kernel.data.copy_(convert.from_flax_layout(
        torch.from_numpy(v["params"]["kernel"].copy())))
    got = resnet.to_nchw(torch.from_numpy(x))
    assert resnet.same_pads(8, 3, 2) == (0, 1)
    np.testing.assert_allclose(
        port(got).permute(0, 2, 3, 1).detach().numpy(), want, atol=1e-5)
    symmetric = torch.nn.functional.conv2d(got, port.kernel, stride=2,
                                           padding=1)
    assert np.abs(symmetric.permute(0, 2, 3, 1).detach().numpy()
                  - want).max() > 1e-2


def test_stem_kernel_to_s2d_is_exact():
    rng = np.random.default_rng(3)
    k7 = rng.normal(size=(7, 7, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(resnet.stem_kernel_to_s2d(k7),
                                  jax_stem_kernel_to_s2d(k7))
    # The two stems compute one function (float64: exact but for the
    # order of the sums).
    x = torch.from_numpy(_images(rng, 2, 16)).double()
    conv7 = resnet.Conv(3, 5, (7, 7), 2, ((3, 3), (3, 3)),
                        dtype=torch.float64)
    s2d = resnet.Conv(12, 5, (4, 4), 1, ((2, 1), (2, 1)),
                      dtype=torch.float64)
    conv7.kernel.data.copy_(convert.from_flax_layout(torch.from_numpy(k7)))
    s2d.kernel.data.copy_(convert.from_flax_layout(
        torch.from_numpy(resnet.stem_kernel_to_s2d(k7))))
    a = conv7(resnet.to_nchw(x))
    b = s2d(resnet.to_nchw(resnet.space_to_depth(x, 2)))
    assert a.shape == b.shape == (2, 5, 8, 8)
    assert float((a - b).abs().max().detach()) < 1e-12
    with pytest.raises(ValueError, match="7x7"):
        resnet.stem_kernel_to_s2d(np.zeros((3, 3, 3, 4), np.float32))


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_resnet50_tree_matches_eval_shape(stem):
    shapes = jax.eval_shape(jax_resnet50(stem=stem).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))
    want = {coll: {tuple(k.key for k in path): tuple(leaf.shape)
                   for path, leaf in jax.tree_util.tree_leaves_with_path(
                       shapes[coll])}
            for coll in shapes}
    model = resnet.resnet50(stem=stem, device="cpu")
    assert convert.variable_shapes(model) == want
    leaves = convert.variable_layout(model).leaves
    for coll, flat in leaves.items():
        assert {path: tuple(convert.to_flax_layout(t).shape)
                for path, t in flat.items()} == want[coll]
    count = sum(int(np.prod(s)) for s in want["params"].values())
    assert sum(p.numel() for p in model.parameters()) == count
    # ResNet-50's 25.56 M; the s2d stem's 4x4x12 kernel is 2,880 more.
    assert count == 25_557_032 + (2_880 if stem == "s2d" else 0)
    assert model.n_blocks == 16


def test_mnist_logits_match_flax():
    rng = np.random.default_rng(5)
    x = _images(rng, 4, 28, 1)
    jm = JaxMnist(dtype=jnp.float32)
    v = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), x)), rng)
    model = convert.load_variables(
        MnistCNN(dtype=torch.float32, device="cpu"), v)
    assert convert.variable_shapes(model) == {
        "params": {p: a.shape for p, a in _flat(v["params"]).items()},
        "batch_stats": {}}
    _assert_logits_close(model(torch.from_numpy(x)), jm.apply(v, x))
    # The default compute dtype is bf16, as JAX's; the head stays f32.
    bf16 = convert.load_variables(MnistCNN(device="cpu"), v)
    out = bf16(torch.from_numpy(x))
    assert bf16.Conv_0.dtype == torch.bfloat16 and out.dtype == torch.float32
    want = np.asarray(JaxMnist().apply(v, x))
    assert np.abs(out.detach().numpy() - want).max() < 0.05 * np.abs(
        want).max()


@pytest.mark.parametrize("kind", ["resnet-conv7", "resnet-s2d", "mnist"])
def test_init_variables_follows_flax_inits(kind):
    if kind == "mnist":
        model, scale = MnistCNN(device="cpu"), 1.0
    else:
        model, scale = _port_resnet(kind.split("-")[1]), 2.0
    tree = convert.init_variables(model, 0)
    assert {c: {p: a.shape for p, a in _flat(t).items()}
            for c, t in tree.items()} == convert.variable_shapes(model)
    again = convert.init_variables(model, 0)
    for path, a in _flat(tree["params"]).items():
        np.testing.assert_array_equal(a, _flat(again["params"])[path])
        assert a.dtype == np.float32
        if path[-1] == "kernel" and not (kind != "mnist"
                                         and path[0] == "Dense_0"):
            # Truncated normal at variance scale / fan_in, cut at 2 std.
            fan_in = int(np.prod(a.shape[:-1]))
            std = np.sqrt(scale / fan_in)
            assert np.abs(a).max() <= 2 * std / 0.87962566103423978 + 1e-6
            if a.size >= 512:
                assert abs(a.std() / std - 1) < 0.15, (path, a.std(), std)
        elif path[-1] == "scale":
            assert (a == (0.0 if path[-2] == "BatchNorm_2" else 1.0)).all()
        else:
            assert not a.any(), path
    for path, a in _flat(tree["batch_stats"]).items():
        assert (a == (0.0 if path[-1] == "mean" else 1.0)).all()
    convert.load_variables(model, tree)
    back = convert.export_variables(model)
    for coll in tree:
        for path, a in _flat(tree[coll]).items():
            np.testing.assert_array_equal(_flat(back[coll])[path], a)


def test_load_variables_names_missing_and_misshapen_leaves():
    model = _port_resnet("conv7")
    tree = convert.init_variables(model, 0)
    del tree["params"]["Dense_0"]["bias"]
    with pytest.raises(ValueError, match="missing.*Dense_0/bias"):
        convert.load_variables(model, tree)
    tree = convert.init_variables(model, 0)
    tree["params"]["Conv_0"]["kernel"] = np.zeros((7, 7, 3, 4), np.float32)
    with pytest.raises(ValueError, match=r"Conv_0/kernel: shape "
                                         r"\(7, 7, 3, 4\).*\(7, 7, 3, 8\)"):
        convert.load_variables(model, tree)


def _optimisers(name):
    if name == "sgd":
        return jax_steps.sgd_momentum(0.1), steps.sgd_momentum(0.1)
    return (jax_steps.lars(jax_steps.warmup_cosine(1.0, 10,
                                                   warmup_steps=1)),
            steps.lars(steps.warmup_cosine(1.0, 10, warmup_steps=1)))


def _run_both(jm, model, v, jtx, tx, batches, has_batch_stats):
    jstate = jax_steps.TrainState.create(
        v["params"], jtx, batch_stats=v.get("batch_stats"))
    jstep = jax_steps.make_classifier_train_step(
        jm, jtx, _mesh(), has_batch_stats=has_batch_stats, donate=False)
    state = steps.TrainState.create(model, tx)
    step = steps.make_classifier_train_step(
        model, tx, has_batch_stats=has_batch_stats)
    for batch in batches:
        jstate, jmet = jstep(jstate, batch)
        state, met = step(state, batch)
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= LOSS_TOL * max(
            1.0, abs(float(jmet["loss"])))
        assert float(met["accuracy"]) == float(jmet["accuracy"])
    assert state.step == int(jstate.step) == len(batches)
    return jstate, state


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
@pytest.mark.parametrize("opt", ["sgd", "lars"])
def test_three_classifier_steps_match_jax(opt, stem):
    """On randomized leaves: JAX's own init (zero head, zero last-BN
    scales) keeps the first steps' activations so small that ReLU inputs
    lie within ~1e-6 of 0, where the two frameworks' last-place forward
    differences pick either side of the kink and move a BN bias's
    gradient by ~10 % (measured). The zero-norm rule that init meets is
    held in test_lars_zero_norm_rule_matches_optax."""
    rng = np.random.default_rng(11)
    batches = [{"image": _images(rng, 8, 16),
                "label": rng.integers(0, CLASSES, (8,)).astype(np.int32)}
               for _ in range(3)]
    jm = _jax_resnet(stem)
    v = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(1), batches[0]["image"])), rng)
    model = convert.load_variables(_port_resnet(stem), v)
    jtx, tx = _optimisers(opt)
    jstate, state = _run_both(jm, model, v, jtx, tx, batches, True)
    got = convert.export_variables(model)
    _assert_leaves_close(got["params"], jstate.params, LEAF_RTOL)
    _assert_leaves_close(got["batch_stats"], jstate.batch_stats, LEAF_RTOL)
    assert set(state.batch_stats) == {
        ".".join(p) for p in _flat(jstate.batch_stats)}


def test_three_mnist_steps_match_jax():
    rng = np.random.default_rng(12)
    batches = [{"image": _images(rng, 8, 28, 1),
                "label": rng.integers(0, 10, (8,)).astype(np.int32)}
               for _ in range(3)]
    jm = JaxMnist(dtype=jnp.float32)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                         batches[0]["image"]))
    model = convert.load_variables(
        MnistCNN(dtype=torch.float32, device="cpu"), v)
    jtx, tx = _optimisers("sgd")
    jstate, state = _run_both(jm, model, v, jtx, tx, batches, False)
    _assert_leaves_close(convert.export_variables(model)["params"],
                         jstate.params, LEAF_RTOL)
    assert state.batch_stats is None


def test_lars_zero_norm_rule_matches_optax():
    """A zero weight and a zero gradient each take trust ratio 1; a 1-D
    leaf skips decay and ratio; a 2-D one gets both."""
    rng = np.random.default_rng(4)
    params = {"w0": np.zeros((3, 4), np.float32),
              "w1": rng.normal(size=(3, 4)).astype(np.float32),
              "w2": rng.normal(size=(2, 2, 3, 3)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=a.shape).astype(np.float32)
              for k, a in params.items()} for _ in range(3)]
    grads[1]["w1"] = np.zeros_like(params["w1"])
    jtx = jax_steps.lars(0.5, weight_decay=0.1)
    jparams, jopt = params, jtx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(a.copy()))
               for k, a in params.items()}
    opt = steps.lars(0.5, weight_decay=0.1)
    torch_opt = opt.init(torch.nn.ParameterList(tparams.values()))
    assert isinstance(torch_opt, steps.LarsSGD)
    for g in grads:
        updates, jopt = jtx.update(g, jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        torch_opt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7)


def test_synthetic_data_is_jax_bitwise():
    from tf_operator_tpu.train import data as jax_data
    from tf_operator_tpu_torch.train import data

    for port, ref, kw in (
            (data.synthetic_mnist, jax_data.synthetic_mnist,
             dict(batch_size=4, seed=3)),
            (data.synthetic_mnist, jax_data.synthetic_mnist,
             dict(batch_size=4, seed=10_000, flat=True, noise=0.5)),
            (data.synthetic_imagenet, jax_data.synthetic_imagenet,
             dict(batch_size=2, image_size=16, num_classes=7, seed=1))):
        got, want = port(**kw), ref(**kw)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_evaluate_with_a_ragged_tail_matches_jax():
    rng = np.random.default_rng(6)
    x = _images(rng, 8, 16)
    jm = _jax_resnet("conv7")
    v = _randomized(jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), x)), rng)
    model = convert.load_variables(_port_resnet("conv7"), v)
    batches = [{"image": _images(rng, n, 16),
                "label": rng.integers(0, CLASSES, (n,)).astype(np.int32)}
               for n in (8, 8, 3)]
    jstate = jax_steps.TrainState.create(
        v["params"], jax_steps.sgd_momentum(0.1),
        batch_stats=v["batch_stats"])
    jeval = jax_steps.make_classifier_eval_step(jm, _mesh())
    want = jax_steps.evaluate(jeval, jstate, iter(batches))
    state = steps.TrainState.create(model, steps.sgd_momentum(0.1))
    eval_step = steps.make_classifier_eval_step(model)
    seen = []

    class Spy:
        shard_count = eval_step.shard_count

        def __call__(self, st, batch):
            seen.append(np.asarray(batch["image"]).shape[0])
            return eval_step(st, batch)

    got = steps.evaluate(Spy(), state, iter(batches))
    assert seen == [8, 8, 8]  # every batch padded to the first one's rows
    assert got["count"] == want["count"] == 19
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL * max(
        1.0, abs(want["loss"]))
    with pytest.raises(ValueError, match="no non-empty batches"):
        steps.evaluate(eval_step, state, iter([]))


def test_classifier_step_refusals():
    model = _port_resnet("conv7")
    tx = steps.sgd_momentum(0.1)
    with pytest.raises(ValueError, match="has_batch_stats=False"):
        steps.make_classifier_train_step(model, tx, has_batch_stats=False)
    with pytest.raises(ValueError, match="has_batch_stats=True"):
        steps.make_classifier_eval_step(MnistCNN(device="cpu"))
    # A data-parallel mesh is ported (A8a); expert and pipeline axes
    # wait for A8e and A8d.
    with pytest.raises(NotImplementedError, match="A8e"):
        steps.make_classifier_train_step(model, tx, mesh=port_mesh.create_mesh(
            {"dp": 1, "ep": 2}, range(2)))
    with pytest.raises(NotImplementedError, match="A8d"):
        steps.make_classifier_eval_step(model, mesh=port_mesh.create_mesh(
            {"dp": 1, "pp": 2}, range(2)))
    assert steps.make_classifier_eval_step(
        model, mesh=port_mesh.create_mesh({"dp": 1}, range(1))
    ).shard_count == 1
    with pytest.raises(ValueError, match="unknown stem"):
        resnet.ResNet(STAGES, stem="conv5", device="cpu")


def _trainer(seed):
    model = _port_resnet("s2d")
    convert.load_variables(model, convert.init_variables(model, seed))
    tx = steps.sgd_momentum(0.1)
    return (steps.TrainState.create(model, tx),
            steps.make_classifier_train_step(model, tx))


def _assert_same_state(a, b):
    for (name, x), (_, y) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        assert torch.equal(x, y), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])
    assert a.step == b.step


def test_checkpoint_round_trip_with_batch_stats(tmp_path):
    rng = np.random.default_rng(8)
    batches = [{"image": _images(rng, 8, 16),
                "label": rng.integers(0, CLASSES, (8,)).astype(np.int32)}
               for _ in range(3)]
    state, step = _trainer(0)
    for batch in batches[:2]:
        state, _ = step(state, batch)
    with CheckpointManager(str(tmp_path / "ck")) as mgr:
        assert mgr.save(1, state)
        mgr.wait()
        fresh, fresh_step = _trainer(5)
        assert mgr.restore(None, fresh) is fresh
    _assert_same_state(fresh, state)
    state, m1 = step(state, batches[2])
    fresh, m2 = fresh_step(fresh, batches[2])
    assert m1["loss"].item() == m2["loss"].item()
    _assert_same_state(fresh, state)
    # The file holds flax's layout: params and batch_stats as
    # export_variables gives them, the momentum under the params' paths.
    payload = torch.load(str(tmp_path / "ck" / "1" / checkpoint.STATE_FILE),
                         weights_only=True)
    assert set(payload) == {"params", "batch_stats", "opt", "step"}
    assert set(payload["opt"]) == {"momentum_buffer"}
    want = convert.variable_shapes(fresh.model)
    for coll in ("params", "batch_stats"):
        assert {p: tuple(t.shape) for p, t in _flat(payload[coll]).items()
                } == want[coll]
    assert {p: tuple(t.shape) for p, t in _flat(
        payload["opt"]["momentum_buffer"]).items()} == want["params"]
    manifest = checkpoint.read(str(tmp_path / "ck"), 1)[1]
    assert manifest["config"] == {"model": "ResNet", "stage_sizes": [1, 1],
                                  "num_classes": CLASSES, "width": WIDTH,
                                  "stem": "s2d"}
    other = resnet.ResNet(STAGES, CLASSES, 16, torch.float32, "s2d",
                          device="cpu")
    ostate = steps.TrainState.create(other, steps.sgd_momentum(0.1))
    with pytest.raises(ValueError, match=r"width 8 \(checkpoint\) vs 16"):
        CheckpointManager(str(tmp_path / "ck")).restore(1, ostate)
    mnist = MnistCNN(device="cpu")
    mstate = steps.TrainState.create(mnist, steps.sgd_momentum(0.1))
    with pytest.raises(ValueError, match="model ResNet .checkpoint. vs "
                                         "MnistCNN"):
        CheckpointManager(str(tmp_path / "ck")).restore(1, mstate)
    assert os.listdir(tmp_path / "ck") == ["1"]
