"""The port stands alone: ``tf_operator_tpu_torch`` and every submodule
import with JAX, flax, optax, orbax and the JAX package poisoned in
``sys.modules``, and neither the package nor ``chip_smoke.py`` names
them in an import. Its entry points default to the CUDA card and raise
when there is none."""

import os
import re
import subprocess
import sys
from dataclasses import replace

import pytest
import torch

from tf_operator_tpu_torch import resolve_device
from tf_operator_tpu_torch.models.convert import init_params
from tf_operator_tpu_torch.models.spec_decode import speculative_generate
from tf_operator_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    generate,
)
from tf_operator_tpu_torch.models.mnist import MnistCNN
from tf_operator_tpu_torch.models.resnet import ResNet
from tf_operator_tpu_torch.random import PRNGKey
from tf_operator_tpu_torch.serve import serve_lm
from tf_operator_tpu_torch.serve.engine import ContinuousEngine
from tf_operator_tpu_torch.train import dist_lm, dist_mnist, dist_multislice

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "tf_operator_tpu_torch")

POISONED_IMPORT = """
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "orbax", "tf_operator_tpu"):
    sys.modules[name] = None
import tf_operator_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tf_operator_tpu_torch.__path__, "tf_operator_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
print(len(names))
"""


def test_package_imports_with_jax_and_the_reference_poisoned():
    out = subprocess.run(
        [sys.executable, "-c", POISONED_IMPORT], cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    # Every module was imported: ckpt (1: protocol), models (6: convert,
    # mnist, moe, resnet, spec_decode, transformer), native (2: augment,
    # pipeline; the package builds its C++ with g++ only when called),
    # ops (4: _build,
    # flash_attention, int8_dense, paged_attention), runtime (2: metrics,
    # tracing), parallel (2: mesh, sharding), serve (13: coalesce,
    # constrain, disagg, engine, kvcache, faultinject, resilience,
    # scheduler, httpapi, serve_lm, sharding, tier, tp), train (9:
    # checkpoint, data, dcn, device_input, dist_lm, dist_mnist,
    # dist_multislice, distributed, steps), utils (1: signals), random and
    # testing, and the nine packages.
    assert int(out.stdout.split()[-1]) >= 50
    for name in ("serve.constrain", "models.spec_decode", "ckpt.protocol",
                 "utils.signals", "train.checkpoint", "train.dist_lm",
                 "serve.disagg", "serve.tier", "serve.coalesce",
                 "models.resnet", "models.mnist", "train.data",
                 "train.device_input", "train.distributed",
                 "train.dist_mnist", "models.moe", "native",
                 "native.pipeline", "native.augment", "parallel",
                 "parallel.mesh", "parallel.sharding", "train.dcn",
                 "serve.sharding", "serve.tp", "train.dist_multislice"):
        assert f"tf_operator_tpu_torch.{name}" in out.stdout.split()


def _sources():
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_source_names_jax_or_the_reference_package():
    banned = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|tf_operator_tpu)\b(?!_)"
        r"|tf_operator_tpu\.", re.M)
    for path in _sources():
        with open(path) as f:
            assert not banned.search(f.read()), path


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = TransformerConfig(vocab_size=16, d_model=16, n_heads=2,
                            n_layers=1, d_ff=16, max_seq_len=16,
                            dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(cfg, init_params(cfg, 0), 2, kv_block=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(replace(cfg, decode=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(cfg, init_params(cfg, 0), torch.zeros((1, 2), dtype=int),
                 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRNGKey(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        speculative_generate(cfg, init_params(cfg, 0), cfg,
                             init_params(cfg, 0),
                             torch.zeros((1, 2), dtype=int), 2, k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(cfg, init_params(cfg, 0), 2, kv_block=8, spec_k=1,
                         draft_cfg=cfg, draft_params=init_params(cfg, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousEngine(cfg, init_params(cfg, 0), 2, kv_paged=False)
    # The server: its builder and its entry point raise before they build
    # or train anything; only --device cpu serves on the CPU.
    for flags in ({}, {"kv_paged": False}, {"batch_window": 250.0}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_lm.build_front(cfg, init_params(cfg, 0),
                                 serve_lm.front_args(**flags))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--train-steps", "0"])
    # The trainers' entry points, likewise, and the classifiers.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_lm.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_mnist.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_multislice.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ResNet((1, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MnistCNN()
    assert resolve_device("cpu") == torch.device("cpu")
