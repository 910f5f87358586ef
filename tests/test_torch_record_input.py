"""The port's record input (tf_operator_tpu_torch/native/, the record
readers of tf_operator_tpu_torch/train/data.py) against the JAX
package's on the CPU, bitwise: the data are bytes and ints. The same
epoch orders (C and Python, sharded), the same batches from both
RecordPipeline engines and from MMapRecordPipeline, the same crops and
flips from the three augment entry points (C and NumPy), the same
record_dataset and token_dataset streams, the same record files, and
fill_stacked against bench.py's next_stacked built from JAX's pieces.
The error contracts too: a producer fault raises in next(), close()
unblocks a blocked reader, a bad record size or an empty shard raises.
Needs g++ (both packages build their C++ with it), not nvcc."""

import threading

import numpy as np
import pytest
import torch

from tf_operator_tpu.native import augment as jax_augment
from tf_operator_tpu.native import pipeline as jax_pipeline
from tf_operator_tpu.train import data as jax_data
from tf_operator_tpu_torch.native import NativeBuildError, load_library
from tf_operator_tpu_torch.native import augment, pipeline
from tf_operator_tpu_torch.train import data

torch.set_num_threads(1)

RECORDS, REC_BYTES = 23, 8
SHARDS = [(0, 1), (0, 3), (2, 3)]


@pytest.fixture()
def record_file(tmp_path):
    rows = np.random.default_rng(0).integers(
        0, 256, (RECORDS, REC_BYTES), dtype=np.uint8)
    path = str(tmp_path / "recs.bin")
    pipeline.write_records(path, rows)
    return path, rows


@pytest.fixture()
def image_file(tmp_path):
    """11 uint8 records of 12 x 10 x 3 image bytes and an int32 label."""
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (11, 12, 10, 3), dtype=np.uint8)
    labels = rng.permutation(1000)[:11].astype(np.int32)
    path = str(tmp_path / "images.bin")
    rec = data.write_example_records(path, images, labels)
    return path, rec, images, labels


def test_the_native_library_builds_and_binds():
    lib = load_library("record_pipeline.cc")
    assert lib is load_library("record_pipeline.cc")
    for name in ("dp_open", "dp_next", "dp_epoch_order", "dp_num_records",
                 "dp_close"):
        assert hasattr(lib, name)
    lib = load_library("augment.cc")
    assert hasattr(lib, "aug_batch") and hasattr(lib, "aug_gather")
    with pytest.raises(FileNotFoundError):
        load_library("missing.cc")


def test_a_failed_build_raises_and_stays_failed(tmp_path, monkeypatch):
    from tf_operator_tpu_torch import native

    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_DIR", str(tmp_path))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_CACHE", {})
    with pytest.raises(NativeBuildError, match="compile failed"):
        load_library("bad.cc")
    with pytest.raises(NativeBuildError, match="previous build"):
        load_library("bad.cc")
    assert not [f for f in (tmp_path / "_build").iterdir()
                if f.name.endswith(".tmp")]


@pytest.mark.parametrize("shard", SHARDS)
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n", [1, 7, 1000])
def test_epoch_order_is_jax_s(n, shuffle, shard):
    """Port python = JAX python = port native = JAX native, epochs 0-2."""
    for epoch in range(3):
        args = (n, 5, epoch, shuffle, *shard)
        want = jax_pipeline.epoch_order(*args, engine="python")
        got = {
            "port python": pipeline.epoch_order(*args, engine="python"),
            "port native": pipeline._native_epoch_order(*args),
            "jax native": jax_pipeline._native_epoch_order(*args),
            "port auto": pipeline.epoch_order(*args),
        }
        assert len(want) == n // shard[1]
        for label, order in got.items():
            assert order is not None, label
            assert order.dtype == np.uint64, label
            np.testing.assert_array_equal(order, want, err_msg=label)


def _batches(module, path, engine, count, shard, **kw):
    kw = dict(dict(seed=7, shuffle=True, loop=True, prefetch=2,
                   threads=2), **kw)
    with module.RecordPipeline(path, REC_BYTES, 4, engine=engine,
                               shard_id=shard[0], num_shards=shard[1],
                               **kw) as p:
        if module is pipeline:
            assert p.engine_name == {"native": "NativeEngine",
                                     "python": "PythonEngine"}[engine]
        it = iter(p)
        return [next(it) for _ in range(count)]


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_record_pipeline_is_jax_s(record_file, engine, shard):
    """Two looping epochs, each ending on a short batch: the port's engine
    batch for batch against JAX's same engine and the port's other one."""
    path, rows = record_file
    per_epoch = -(-(RECORDS // shard[1]) // 4)
    count = 2 * per_epoch
    got = _batches(pipeline, path, engine, count, shard)
    want = _batches(jax_pipeline, path, engine, count, shard)
    other = _batches(pipeline, path,
                     {"native": "python", "python": "native"}[engine],
                     count, shard)
    assert [len(b) for b in got[:per_epoch]][-1] < 4  # the short tail
    for i, (g, w, o) in enumerate(zip(got, want, other)):
        np.testing.assert_array_equal(g, w, err_msg=f"batch {i}")
        np.testing.assert_array_equal(g, o, err_msg=f"batch {i}")
    order = jax_pipeline.epoch_order(RECORDS, 7, 1, True, *shard,
                                     engine="python")
    np.testing.assert_array_equal(np.concatenate(got[per_epoch:]),
                                  rows[order.astype(np.int64)])


@pytest.mark.parametrize("engine", ["native", "python"])
def test_one_epoch_then_the_end(record_file, engine):
    path, rows = record_file
    with pipeline.RecordPipeline(path, REC_BYTES, 4, engine=engine,
                                 shuffle=False) as p:
        got = np.concatenate(list(p))
        assert p.num_records == RECORDS
    np.testing.assert_array_equal(got, rows)


@pytest.mark.parametrize("case", ["size", "empty-file", "empty-shard",
                                  "bad-shard", "engine"])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_bad_inputs_raise(tmp_path, record_file, case, engine):
    path, _ = record_file
    kw = {}
    if case == "size":
        path = str(tmp_path / "bad.bin")
        with open(path, "wb") as f:
            f.write(b"x" * 13)  # not a multiple of 8
    elif case == "empty-file":
        path = str(tmp_path / "empty.bin")
        open(path, "wb").close()
    elif case == "empty-shard":
        kw = dict(shard_id=0, num_shards=RECORDS + 1)
    elif case == "bad-shard":
        kw = dict(shard_id=3, num_shards=3)
    else:
        engine = "torch"
    # The native engine's open failure is a NativeBuildError (a
    # RuntimeError), the Python engine's a ValueError: each as JAX's.
    with pytest.raises((ValueError, RuntimeError)) as got:
        pipeline.RecordPipeline(path, REC_BYTES, 4, engine=engine, **kw)
    with pytest.raises((ValueError, RuntimeError)) as want:
        jax_pipeline.RecordPipeline(path, REC_BYTES, 4, engine=engine, **kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_a_producer_fault_raises_in_next(tmp_path):
    """A file that shrinks under the Python engine's reader: next() raises
    IOError, never hangs (the native engine's dp_next -> -1 contract)."""
    path = str(tmp_path / "shrink.bin")
    pipeline.write_records(path, np.zeros((10, REC_BYTES), np.uint8))
    p = pipeline.RecordPipeline(path, REC_BYTES, 4, engine="python",
                                shuffle=False, loop=True, prefetch=1)
    with open(path, "wb") as f:
        f.write(b"x" * REC_BYTES)
    try:
        with pytest.raises(IOError, match="producer failed"):
            for _ in range(20):
                if p._engine.next() is None:
                    break
    finally:
        p.close()


def test_close_unblocks_a_concurrent_reader(record_file):
    """A reader blocked in the Python engine's next() while close() runs
    terminates, even when the size-1 prefetch queue refills between
    close's drain and its sentinel."""
    path, _ = record_file
    p = pipeline.RecordPipeline(path, REC_BYTES, 4, engine="python", seed=1,
                                shuffle=False, loop=True, prefetch=1)
    it = iter(p)
    next(it)

    def reader():
        while next(it, None) is not None:
            pass

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    p.close()
    t.join(timeout=5)
    assert not t.is_alive(), "reader hung after close()"


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_mmap_stream_and_labels_are_record_pipeline_s(record_file, shard):
    """MMapRecordPipeline's indices give RecordPipeline's rows over two
    looping epochs, and its labels (the trailing byte) theirs; both equal
    JAX's MMapRecordPipeline's."""
    path, rows = record_file
    kw = dict(seed=7, loop=True, shard_id=shard[0], num_shards=shard[1])
    mm = pipeline.MMapRecordPipeline(path, REC_BYTES, 4, **kw)
    jm = jax_pipeline.MMapRecordPipeline(path, REC_BYTES, 4, **kw)
    per_epoch = -(-(RECORDS // shard[1]) // 4)
    want = _batches(pipeline, path, "native", 2 * per_epoch, shard)
    for i, batch in enumerate(want):
        idx, jidx = mm.next_indices(), jm.next_indices()
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(rows[idx.astype(np.int64)], batch,
                                      err_msg=f"batch {i}")
        labels = mm.labels(idx)
        assert labels.dtype == np.int32
        np.testing.assert_array_equal(labels, batch[:, -1])
        np.testing.assert_array_equal(labels, jm.labels(jidx))
        np.testing.assert_array_equal(mm.labels(idx, offset=0), batch[:, 0])
    mm.close()
    assert mm.data is None
    once = pipeline.MMapRecordPipeline(path, REC_BYTES, 4, loop=False)
    seen = []
    while (idx := once.next_indices()) is not None:
        seen.append(idx)
    assert sorted(np.concatenate(seen).tolist()) == list(range(RECORDS))


def test_mmap_bad_inputs_raise(tmp_path, record_file):
    path, _ = record_file
    for kw, match in ((dict(shard_id=0, num_shards=RECORDS + 1), "empty"),
                      (dict(shard_id=2, num_shards=2), "bad shard")):
        with pytest.raises(ValueError, match=match):
            pipeline.MMapRecordPipeline(path, REC_BYTES, 4, **kw)
    with pytest.raises(ValueError, match="not a multiple"):
        pipeline.MMapRecordPipeline(path, 7, 4)


def _images(seed, n=6, h=20, w=16, c=3):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, c),
                                                dtype=np.uint8)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("entry", ["batch", "records", "gather"])
def test_augment_is_jax_s(entry, engine, train):
    """Each entry point, each engine, train and eval: bitwise JAX's native
    and NumPy outputs; out= writes in place."""
    imgs = _images(2)
    n, h, w, c = imgs.shape
    recs = np.concatenate([imgs.reshape(n, -1),
                           np.arange(n, dtype=np.uint8)[:, None]], axis=1)
    idx = np.array([5, 0, 3, 3, 1], np.uint64)
    kw = dict(seed=9, index0=1234, train=train, threads=3)

    def run(mod, eng, out=None):
        if entry == "batch":
            return mod.augment_batch(imgs, (14, 11), engine=eng, **kw)
        if entry == "records":
            return mod.augment_records(recs, (h, w, c), (14, 11),
                                       engine=eng, out=out, **kw)
        return mod.augment_gather(recs.reshape(-1), idx, recs.shape[1],
                                  (h, w, c), (14, 11), engine=eng, out=out,
                                  **kw)

    got = run(augment, engine)
    for eng in ("native", "python"):
        np.testing.assert_array_equal(got, run(jax_augment, eng), eng)
    if not train:
        src = imgs[idx.astype(np.int64)] if entry == "gather" else imgs
        np.testing.assert_array_equal(got, src[:, 3:17, 2:13])
    if entry != "batch":
        out = np.zeros_like(got)
        assert run(augment, engine, out=out) is out
        np.testing.assert_array_equal(out, got)


@pytest.mark.parametrize("engine", ["native", "python"])
def test_augment_bad_inputs_raise(engine):
    imgs = _images(3, n=2, h=8, w=8)
    recs = imgs.reshape(2, -1)
    cases = [
        lambda m: m.augment_batch(imgs.astype(np.float32), (4, 4),
                                  engine=engine),
        lambda m: m.augment_batch(imgs, (16, 4), engine=engine),
        lambda m: m.augment_records(recs[:, :100], (8, 8, 3), (4, 4),
                                    engine=engine),
        lambda m: m.augment_records(recs, (8, 8, 3), (4, 4), engine=engine,
                                    out=np.zeros((2, 4, 4, 3), np.int8)),
        lambda m: m.augment_gather(recs, np.zeros(2, np.uint64), 192,
                                   (8, 8, 3), (4, 4), engine=engine),
        lambda m: m.augment_gather(recs.reshape(-1), np.array([2]), 192,
                                   (8, 8, 3), (4, 4), engine=engine),
        lambda m: m.augment_gather(recs.reshape(-1), np.array([0]), 100,
                                   (8, 8, 3), (4, 4), engine=engine),
        lambda m: m.augment_gather(recs.reshape(-1), np.array([0]), 192,
                                   (8, 8, 3), (9, 4), engine=engine),
        lambda m: m.augment_batch(imgs, (4, 4), engine="torch"),
    ]
    for i, case in enumerate(cases):
        with pytest.raises(ValueError) as got:
            case(augment)
        with pytest.raises(ValueError) as want:
            case(jax_augment)
        assert str(got.value) == str(want.value), i


def _stream(mod, path, rec_shape, count, **kw):
    it = mod.record_dataset(path, *rec_shape, **kw)
    try:
        return [next(it) for _ in range(count)]
    finally:
        it.close()


@pytest.mark.parametrize("crop", [None, (8, 7)])
@pytest.mark.parametrize("engine", ["native", "python", "mmap"])
def test_record_dataset_is_jax_s(image_file, engine, crop):
    """Two epochs of shard 1 of 2 (5 records, batches of 2: short tails),
    with and without the crop, against JAX's stream."""
    path, _, images, labels = image_file
    kw = dict(seed=3, engine=engine, crop_hw=crop, shard_id=1, num_shards=2,
              threads=2)
    got = _stream(data, path, ((12, 10, 3), np.uint8, 2), 6, **kw)
    want = _stream(jax_data, path, ((12, 10, 3), np.uint8, 2), 6, **kw)
    assert [len(b["label"]) for b in got] == [2, 2, 1, 2, 2, 1]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys() == {"image", "label"}
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], f"{i} {key}")
    if crop is None:
        for b in got:
            rows = [int(np.flatnonzero(labels == lab)[0]) for lab in b["label"]]
            np.testing.assert_array_equal(b["image"], images[rows])


def test_record_dataset_validates_crop_at_the_call(image_file):
    path = image_file[0]
    with pytest.raises(ValueError, match="crop_hw needs uint8"):
        data.record_dataset(path, (12, 10, 3), np.float32, 2, crop_hw=(4, 4))


@pytest.mark.parametrize("engine", ["native", "python", "mmap"])
def test_token_dataset_is_jax_s(tmp_path, engine):
    rng = np.random.default_rng(4)
    seqs = rng.integers(0, 50, (13, 9)).astype(np.int32)
    path = str(tmp_path / "tokens.bin")
    assert data.write_token_records(path, seqs) == 9 * 4
    kw = dict(seed=11, engine=engine, shard_id=0, num_shards=2)
    got, want = (mod.token_dataset(path, 8, 4, **kw) for mod in (data,
                                                                 jax_data))
    for i in range(5):
        g, w = next(got), next(want)
        np.testing.assert_array_equal(g["tokens"], w["tokens"], str(i))
        np.testing.assert_array_equal(g["targets"], w["targets"], str(i))
        assert g["tokens"].dtype == np.int32
        np.testing.assert_array_equal(g["tokens"][:, 1:],
                                      g["targets"][:, :-1])
    got.close()
    want.close()


def test_the_writers_write_jax_s_bytes(tmp_path):
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 1 << 20, (7, 33)).astype(np.int64)
    feats = rng.normal(size=(5, 3, 4)).astype(np.float32)
    labels = np.arange(5, dtype=np.int32)
    for name, write, args in (
            ("tokens", "write_token_records", (seqs,)),
            ("examples", "write_example_records", (feats, labels)),
            ("unlabelled", "write_example_records", (feats,)),
    ):
        a, b = str(tmp_path / f"{name}.port"), str(tmp_path / f"{name}.jax")
        assert (getattr(data, write)(a, *args)
                == getattr(jax_data, write)(b, *args))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), name
    with pytest.raises(ValueError, match="expected"):
        data.write_token_records(a, seqs.reshape(-1))


def test_synthetic_tokens_are_jax_s():
    got = data.synthetic_tokens(3, 10, vocab_size=40, seed=2)
    want = jax_data.synthetic_tokens(3, 10, vocab_size=40, seed=2)
    for _ in range(3):
        g, w = next(got), next(want)
        for key in ("tokens", "targets"):
            assert g[key].dtype == np.int32
            np.testing.assert_array_equal(g[key], w[key])


def test_fill_stacked_is_bench_next_stacked(tmp_path):
    """bench.py's next_stacked, built from JAX's MMapRecordPipeline and
    its NumPy augment_gather, against fill_stacked into caller buffers:
    two calls of 3 steps of 4 over 10 records, so the stream crosses
    epochs and tops up their short last batches."""
    rng = np.random.default_rng(6)
    rec_bytes = 16 * 16 * 3 + 1
    path = str(tmp_path / "bench.bin")
    rng.integers(0, 256, (10, rec_bytes), dtype=np.uint8).tofile(path)
    steps, batch = 3, 4
    port = pipeline.MMapRecordPipeline(path, rec_bytes, batch, seed=0,
                                       loop=True)
    ref = jax_pipeline.MMapRecordPipeline(path, rec_bytes, batch, seed=0,
                                          loop=True)
    images = np.zeros((steps, batch, 12, 12, 3), np.uint8)
    labels = np.zeros((steps, batch), np.int32)
    index0 = count = 0
    for _ in range(2):
        index0 = data.fill_stacked(port, (16, 16, 3), images, labels,
                                   seed=1, index0=index0, threads=2)
        for s in range(steps):
            idx = ref.next_indices()
            while len(idx) < batch:
                idx = np.concatenate([idx, ref.next_indices()])[:batch]
            want = jax_augment.augment_gather(
                ref.data, idx, rec_bytes, (16, 16, 3), (12, 12), seed=1,
                index0=count, engine="python")
            count += batch
            np.testing.assert_array_equal(images[s], want, str(s))
            np.testing.assert_array_equal(labels[s], ref.labels(idx) % 1000)
    assert index0 == count == 2 * steps * batch
