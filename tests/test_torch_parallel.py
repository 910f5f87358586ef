"""The port's meshes, topology reader and DCN channel held against the JAX
package on the CPU:

- ``create_mesh``, ``multislice_mesh``, ``slice_mesh`` and
  ``host_local_batch_size`` (tf_operator_tpu_torch/parallel/mesh.py) on
  the same axis dicts as JAX's over the conftest's 8 virtual devices:
  axis names, shapes and the device ids laid out as the port lays out
  ranks, exactly; the same errors with the same messages.
- ``Mesh.members`` gives a dimension's shards in JAX's order for a tuple
  of data axes; a mesh that shards sp, tp or ep trains (ep beside tp
  too, A8i) and one that shards pp is refused by the plain
  steps and the model config, naming train/pp_lm.py's
  make_pp_lm_train_step (A8d); the placement helpers of A8b and A8e
  (``fsdp_sharding_tree``, ``shard_params_fsdp``,
  ``weight_update_shardings``) give JAX's specs and slices.
- ``distributed.from_env`` against JAX's ``from_env`` over a table of
  envs (the coordinator, the hostnames, an evaluator, TF_CONFIG of
  several workers): every field equal.
- The DCN channel (train/dcn.py): a port leader and a JAX
  ``CrossSliceChannel`` leader allreduce through one coordinator, each
  as slice 0 in turn (the wire format is shared), and the result is
  ``np.mean`` exactly; a job of 2 slices x 2 processes, each slice its
  own gloo world, gets ``np.mean`` of the leaders' trees on all four
  processes from ``cross_slice_mean``.
"""

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from tf_operator_tpu.parallel import mesh as jax_mesh
from tf_operator_tpu.topology.slices import TopologyError as JaxTopologyError
from tf_operator_tpu.train import dcn as jax_dcn
from tf_operator_tpu.train import distributed as jax_distributed
from tf_operator_tpu_torch.models.transformer import TransformerConfig
from tf_operator_tpu_torch.parallel import mesh, sharding
from tf_operator_tpu_torch.train import dcn, distributed, steps
from test_torch_dp import free_port, run_processes

torch.set_num_threads(1)

MESH_CASES = [
    None,
    {"dp": -1},
    {"dp": 8},
    {"tp": 2, "dp": -1},
    {"dp": 2, "fsdp": 2, "tp": 2},
    {"sp": 2, "dp": 2, "pp": 2},
    {"ep": 4, "dp": 2},
    {"custom": 2, "dp": 4},
    {"dp": -1, "tp": -1},
    {"dp": 3},
    {"dp": -1, "tp": 3},
]


def _same(fn_port, fn_jax):
    """Both raise the same message, or both give meshes of one layout."""
    try:
        want = fn_jax()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fn_port()
        assert str(got.value) == str(e)
        return None
    got = fn_port()
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    return got


@pytest.mark.parametrize("axes", MESH_CASES)
def test_create_mesh_matches_jax(axes):
    devices = jax.devices()[:8]
    _same(lambda: mesh.create_mesh(axes, range(8)),
          lambda: jax_mesh.create_mesh(axes, devices))


@pytest.mark.parametrize("slices,axes", [
    (2, None), (2, {"dp": 2, "tp": 2}), (4, {"fsdp": 2}), (3, None),
    (2, {"dp": 3})])
def test_multislice_mesh_matches_jax(slices, axes):
    devices = jax.devices()[:8]
    got = _same(lambda: mesh.multislice_mesh(slices, axes, range(8)),
                lambda: jax_mesh.multislice_mesh(slices, axes, devices))
    if got is not None:
        assert got.axis_names[0] == "dcn"


@pytest.mark.parametrize("accel,topo,n", [
    ("v5e-8", None, 8), ("v5e-8", "2x4", 8), ("v4-8", None, 8),
    ("v5e-4", None, 8), ("v5e-8", "4x4", 8), ("v9-8", None, 8),
    ("v5e-x", None, 8), ("v5e-0", None, 8), ("v5e-512", None, 8),
    ("v5e-8", "2xa", 8), ("v5e-12", None, 8), ("V5E-8", None, 8),
])
def test_slice_mesh_matches_jax(accel, topo, n):
    devices = jax.devices()[:n]
    try:
        want = jax_mesh.slice_mesh(accel, topo, devices)
    except (ValueError, JaxTopologyError) as e:
        with pytest.raises(ValueError) as got:
            mesh.slice_mesh(accel, topo, range(n))
        assert str(got.value) == str(e)
        assert isinstance(got.value, mesh.TopologyError) == isinstance(
            e, JaxTopologyError)
        return
    got = mesh.slice_mesh(accel, topo, range(n))
    assert got.shape == dict(want.shape)


@pytest.mark.parametrize("batch,axes,axis", [
    (16, {"dp": 8}, "dp"), (16, {"dp": 4, "tp": 2}, "dp"),
    (12, {"dp": 8}, "dp"), (16, {"dp": 8}, "sp"), (6, {"fsdp": 4,
                                                       "dp": 2}, "fsdp")])
def test_host_local_batch_size_matches_jax(batch, axes, axis):
    devices = jax.devices()[:8]
    jm, pm = jax_mesh.create_mesh(axes, devices), mesh.create_mesh(axes,
                                                                   range(8))
    try:
        want = jax_mesh.host_local_batch_size(batch, jm, axis)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            mesh.host_local_batch_size(batch, pm, axis)
        return
    assert mesh.host_local_batch_size(batch, pm, axis) == want


def test_members_are_jax_shard_order():
    """A dimension sharded over ("dcn", "dp") on a dcn 2 x dp 2 x tp 2
    mesh: JAX's shard index of each device against the port's position
    of each rank in ``members``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = {"dcn": 2, "dp": 2, "tp": 2}
    jm = jax_mesh.create_mesh(axes, jax.devices()[:8])
    pm = mesh.create_mesh(axes, range(8))
    for data_axis in (("dcn", "dp"), ("dp", "dcn"), ("dp",)):
        sharding_ = NamedSharding(jm, P(data_axis))
        idx = sharding_.devices_indices_map((16,))
        n = int(np.prod([pm.shape[a] for a in data_axis]))
        for dev, (sl,) in idx.items():
            shard = (sl.start or 0) // (16 // n)
            assert pm.members(data_axis, dev.id).index(dev.id) == shard
    assert pm.members(("dp",), 5) == [5, 7]


@pytest.mark.parametrize("axis,item", [("sp", "A8c"), ("tp", "A8b"),
                                       ("ep", "A8e"),
                                       pytest.param(
                                           "pp", "make_pp_lm_train_step",
                                           id="pp-A8d")])
def test_model_parallel_meshes_name_their_item(axis, item):
    m = mesh.create_mesh({"dp": 2, axis: 2}, range(4))
    if axis == "ep":
        # Ported (A8e): a dp x ep mesh splits an MoE model's experts and
        # steps the classifiers, replicated over ep
        # (tests/test_torch_ep.py runs it); beside tp too (A8i,
        # tests/test_torch_a8i.py runs it).
        assert TransformerConfig(mesh=m).mesh is m
        model = torch.nn.Linear(2, 2)
        assert steps.make_classifier_train_step(
            model, steps.sgd_momentum(0.1), has_batch_stats=False, mesh=m)
        assert steps.make_classifier_eval_step(
            model, has_batch_stats=False, mesh=m).shard_count == 2
        both = mesh.create_mesh({"ep": 2, "tp": 2}, range(4))
        assert TransformerConfig(mesh=both).mesh is both
        return
    if axis in ("tp", "sp"):
        # Ported (A8b's second half, A8c): a dp x tp mesh trains the
        # Megatron layout, a dp x sp mesh the sequence-parallel model, and
        # either steps the classifiers, replicated over its axis
        # (tests/test_torch_tp_train.py and tests/test_torch_sp.py run
        # them).
        assert TransformerConfig(mesh=m).mesh is m
        model = torch.nn.Linear(2, 2)
        assert steps.make_classifier_train_step(
            model, steps.sgd_momentum(0.1), has_batch_stats=False, mesh=m)
        assert steps.make_classifier_eval_step(
            model, has_batch_stats=False, mesh=m).shard_count == 2
        return
    # Ported (A8d) through train/pp_lm.py: the plain model and steps
    # refuse a pp mesh, naming its step (tests/test_torch_pp.py runs it).
    with pytest.raises(ValueError, match=item):
        TransformerConfig(mesh=m)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match=f"{axis}=2"):
        steps.make_classifier_train_step(model, steps.sgd_momentum(0.1),
                                         has_batch_stats=False, mesh=m)
    with pytest.raises(ValueError, match=item):
        steps.make_classifier_eval_step(model, has_batch_stats=False,
                                        mesh=m)
    # A data-parallel mesh is taken as it is.
    dp = mesh.create_mesh({"dp": 1, "sp": 1, "tp": 1}, range(1))
    assert TransformerConfig(mesh=dp).mesh is dp


@pytest.mark.parametrize("name,item", [
    ("sharding_tree_by_rules", "A8b"), ("shard_params_by_rules", "A8b"),
    ("fsdp_sharding_tree", "A8e"), ("shard_params_fsdp", "A8e"),
    ("weight_update_shardings", "A8e")])
def test_placements_of_later_items_raise(name, item):
    if item == "A8e":
        # Ported (A8e; tests/test_torch_fsdp.py holds them against JAX on
        # JAX's trees): the largest dimension the axis divides is cut,
        # ties to the earlier one; a small or indivisible leaf is whole.
        m = mesh.create_mesh({"fsdp": 2, "dp": 2}, range(4))
        tree = {"k": np.arange(64.0).reshape(4, 16), "s": np.ones(3),
                "t": np.ones((8, 8)), "n": 7}
        fn = getattr(sharding, name)
        if name == "shard_params_fsdp":
            got = fn(m, tree, min_size=32, rank=3)
            np.testing.assert_array_equal(got["k"], tree["k"][:, 8:])
            np.testing.assert_array_equal(got["t"], tree["t"][4:])
            assert got["n"] == 7 and got["s"].shape == (3,)
            return
        axis = "fsdp" if name == "fsdp_sharding_tree" else "dp"
        assert fn(m, tree, min_size=32) == {
            "k": (None, axis), "s": (), "t": (axis, None), "n": ()}
        return
    if item == "A8b":
        # Ported with A8b's first half (tests/test_torch_tp.py holds them
        # against JAX): a rule's axis that does not tile leaves the leaf
        # whole; one that tiles gives each rank its slice.
        m = mesh.create_mesh({"tp": 2}, range(2))
        tree = {"a": {"kernel": np.arange(12.0).reshape(3, 4)},
                "b": {"kernel": np.arange(6.0).reshape(3, 2)}}
        rules = {"a/kernel": ("tp", None), "b/kernel": (None, "tp")}
        if name == "sharding_tree_by_rules":
            assert getattr(sharding, name)(m, tree, rules) == {
                "a": {"kernel": ()}, "b": {"kernel": (None, "tp")}}
        else:
            got = getattr(sharding, name)(m, tree, rules, rank=1)
            np.testing.assert_array_equal(got["a"]["kernel"],
                                          tree["a"]["kernel"])
            np.testing.assert_array_equal(got["b"]["kernel"],
                                          tree["b"]["kernel"][:, 1:])
        return
    with pytest.raises(NotImplementedError, match=f"{name}.*{item}"):
        getattr(sharding, name)(None, {})


ENVS = [
    {},
    {"TPU_COORDINATOR_ADDRESS": "h0:8476", "TPU_WORKER_ID": "1",
     "TPU_NUM_PROCESSES": "4", "TPU_WORKER_HOSTNAMES": "h0,h1,,h2,h3",
     "TPU_ACCELERATOR_TYPE": "v5e-16", "TPU_TOPOLOGY": "4x4"},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:2222", "w1:2222",
                                                     "w2:2222"]},
                              "task": {"type": "worker", "index": 2}})},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:2222", "w1:2222"],
                                          "evaluator": ["e:2222"]},
                              "task": {"type": "evaluator", "index": 0}})},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:1", "w1:1"]},
                              "task": {"type": "worker", "index": 1}}),
     "TPU_COORDINATOR_ADDRESS": "c:9"},
    {"TF_CONFIG": json.dumps({"cluster": {"worker": ["w0:1", "w1:1"]},
                              "task": {"type": "worker", "index": 0}}),
     "TPU_NUM_PROCESSES": "8"},
    {"TF_CONFIG": json.dumps({"cluster": {"chief": ["c:1"]},
                              "task": {"type": "chief"}})},
    {"TF_CONFIG": "not json", "TPU_NUM_PROCESSES": "2"},
    {"TPU_COORDINATOR_ADDRESS": "h:8476", "TPU_WORKER_ID": "2",
     "TPU_NUM_PROCESSES": "4",
     "TF_CONFIG": json.dumps({"task": {"type": "evaluator"}})},
]
FIELDS = ("coordinator_address", "process_id", "num_processes",
          "accelerator_type", "topology", "worker_hostnames", "role",
          "is_distributed")


@pytest.mark.parametrize("env", ENVS)
def test_from_env_every_field_matches_jax(env):
    want = jax_distributed.from_env(env)
    got = distributed.from_env(env)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field


def test_one_process_initializes_nothing():
    topo = distributed.initialize(distributed.from_env({}), device="cpu")
    assert not topo.is_distributed
    assert not torch.distributed.is_initialized()
    assert distributed.world() == (0, 1)
    assert distributed.agree(True) and not distributed.agree(False)
    with pytest.raises(ValueError, match="nccl backend runs on the card"):
        distributed.initialize(distributed.from_env(ENVS[1]), device="cpu",
                               backend="nccl")


def _leaders(port_slice: int, arrays):
    """A port leader as slice ``port_slice`` and a JAX one as the other,
    each reducing its own arrays -> (port result, JAX result)."""
    addr = f"127.0.0.1:{free_port()}"
    out = {}

    def lead(sid, kind):
        mod = dcn if kind == "port" else jax_dcn
        ch = mod.CrossSliceChannel(sid, 2, addr, is_slice_leader=True,
                                   timeout=30)
        try:
            out[kind] = ch.allreduce(arrays[sid])
        finally:
            ch.close()

    kinds = {port_slice: "port", 1 - port_slice: "jax"}
    threads = [threading.Thread(target=lead, args=(sid, kind))
               for sid, kind in sorted(kinds.items())]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return out["port"], out["jax"]


@pytest.mark.parametrize("port_slice", [0, 1])
def test_port_and_jax_leaders_allreduce_at_one_coordinator(port_slice):
    rng = np.random.default_rng(port_slice)
    arrays = [[rng.normal(size=(3, 4)).astype(np.float32),
               rng.normal(size=(5,)).astype(np.float32)] for _ in range(2)]
    got_port, got_jax = _leaders(port_slice, arrays)
    for i in range(2):
        want = np.mean([arrays[0][i], arrays[1][i]], axis=0)
        np.testing.assert_array_equal(got_port[i], want)
        np.testing.assert_array_equal(got_jax[i], want)


def slice_rank(process_id, num_processes, payload):
    """One process of one slice: its slice's tree (the leader's counts)
    through ``cross_slice_mean``."""
    sid = int(os.environ["MEGASCALE_SLICE_ID"])
    channel = dcn.channel_from_env(in_slice_process_id=process_id,
                                   timeout=60)
    mine = payload[sid] if process_id == 0 else {
        "w": np.full((3, 4), 99.0, np.float32),
        "b": [torch.full((5,), 99.0)]}
    out = dcn.cross_slice_mean(channel, mine)
    if channel is not None:
        channel.close()
    assert isinstance(out["b"][0], torch.Tensor)
    return {"w": out["w"], "b": out["b"][0].numpy()}


def test_two_slices_of_two_processes_mean_across_slices():
    rng = np.random.default_rng(3)
    trees = [{"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [torch.from_numpy(rng.normal(size=(5,)).astype(
                  np.float32))]} for _ in range(2)]
    dcn_addr = f"127.0.0.1:{free_port()}"
    envs = []
    for sid in range(2):
        coord = f"127.0.0.1:{free_port()}"
        for pid in range(2):
            envs.append({**{k: v for k, v in os.environ.items()
                            if k != "TF_CONFIG"},
                         "OMP_NUM_THREADS": "1",
                         "TPU_COORDINATOR_ADDRESS": coord,
                         "TPU_WORKER_ID": str(pid), "TPU_NUM_PROCESSES": "2",
                         "MEGASCALE_NUM_SLICES": "2",
                         "MEGASCALE_SLICE_ID": str(sid),
                         "MEGASCALE_COORDINATOR_ADDRESS": dcn_addr})
    got = run_processes("test_torch_parallel", "slice_rank", envs, trees)
    want_w = np.mean([trees[0]["w"], trees[1]["w"]], axis=0)
    want_b = np.mean([trees[0]["b"][0].numpy(), trees[1]["b"][0].numpy()],
                     axis=0)
    for r in got:
        np.testing.assert_array_equal(r["w"], want_w)
        np.testing.assert_array_equal(r["b"], want_b)
    assert dcn.cross_slice_mean(None, trees[0]) is trees[0]
