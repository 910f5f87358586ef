"""The port's copy of ``tf_operator_tpu/train/data.py``: the synthetic
datasets (deterministic and learnable, the same numpy generators and
seeds, so a seed gives the JAX package's batches) and the record readers
over ``native/`` (``record_dataset``, ``token_dataset`` and their
writers), with the same signatures, defaults, streams and messages.
Batches are host numpy arrays; the train step moves them to its model's
device. Nothing is downloaded.

``fill_stacked`` is ``bench.py``'s ``next_stacked`` of its streamed
ResNet-50 input, writing into buffers its caller owns (a pinned host
tensor, double-buffered for the copy to the card).
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


def synthetic_tokens(
    batch_size: int, seq_len: int, vocab_size: int = 32000, seed: int = 0
) -> Iterator[dict[str, np.ndarray]]:
    """Token streams with next-token structure (shifted-window markov-ish)."""
    rng = np.random.default_rng(seed)
    while True:
        base = rng.integers(0, vocab_size, size=(batch_size, seq_len + 1))
        yield {
            "tokens": base[:, :-1].astype(np.int32),
            "targets": base[:, 1:].astype(np.int32),
        }


def record_dataset(
    path: str,
    example_shape: tuple[int, ...],
    dtype: np.dtype,
    batch_size: int,
    *,
    label_dtype: np.dtype | None = np.dtype(np.int32),
    seed: int = 0,
    shuffle: bool = True,
    loop: bool = True,
    prefetch: int = 4,
    threads: int = 2,
    engine: str = "auto",
    crop_hw: tuple[int, int] | None = None,
    augment_train: bool = True,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[dict[str, np.ndarray]]:
    """Stream {image, label} batches from a binary record file.

    The file layout is one fixed-size record per example: the feature bytes
    (example_shape x dtype) immediately followed by the label
    (label_dtype; omit by passing label_dtype=None). IO, shuffling and
    prefetch run in the native C++ pipeline when available
    (native/record_pipeline.cc) — off the GIL, so the accelerator never
    waits on Python — with a semantics-identical Python fallback.

    crop_hw: for uint8 [H, W, C] examples, crop each image to this size via
    the augment stage (random crop + hflip while augment_train, else center
    crop) — ImageNet-style host preprocessing; ``engine`` selects the
    native/python implementation for the augment stage and the record
    pipeline alike. ``engine="mmap"`` selects the zero-copy tier for
    page-cache-resident files: the file is mmap'd and images are gathered
    (and cropped) straight out of the mapping, with the IDENTICAL sample
    stream (same epoch order, same augment decisions).

    shard_id/num_shards: multi-host input sharding (one disjoint slice of
    every epoch per host — see RecordPipeline).
    """
    dtype = np.dtype(dtype)
    if crop_hw is not None and (dtype != np.uint8 or len(example_shape) != 3):
        # Validate at the call site, not on first next(): the misconfigured
        # call is where the fix belongs.
        raise ValueError(
            f"crop_hw needs uint8 [H,W,C] examples, got {dtype} {example_shape}"
        )
    if engine == "mmap":
        return _mmap_batches(
            path, example_shape, dtype, batch_size, label_dtype, seed,
            shuffle, loop, crop_hw, augment_train, threads,
            shard_id, num_shards,
        )
    return _record_batches(
        path, example_shape, dtype, batch_size, label_dtype, seed, shuffle,
        loop, prefetch, threads, engine, crop_hw, augment_train,
        shard_id, num_shards,
    )


def _mmap_batches(
    path, example_shape, dtype, batch_size, label_dtype, seed, shuffle,
    loop, crop_hw, augment_train, threads, shard_id, num_shards,
) -> Iterator[dict[str, np.ndarray]]:
    from tf_operator_tpu_torch.native.augment import augment_gather
    from tf_operator_tpu_torch.native.pipeline import MMapRecordPipeline

    feat_bytes = int(np.prod(example_shape)) * dtype.itemsize
    rec_bytes = feat_bytes + (
        np.dtype(label_dtype).itemsize if label_dtype is not None else 0
    )
    pipe = MMapRecordPipeline(
        path, rec_bytes, batch_size, seed=seed, shuffle=shuffle, loop=loop,
        shard_id=shard_id, num_shards=num_shards,
    )
    table = np.asarray(pipe.data).reshape(pipe.num_records, rec_bytes)
    sample_index = 0
    try:
        while True:
            idx = pipe.next_indices()
            if idx is None:
                return
            if crop_hw is not None:
                feats = augment_gather(
                    pipe.data, idx, rec_bytes, example_shape, crop_hw,
                    seed=seed, index0=sample_index, train=augment_train,
                    threads=threads,
                )
                sample_index += len(idx)
            else:
                feats = (
                    table[idx, :feat_bytes]
                    .view(dtype)
                    .reshape(len(idx), *example_shape)
                )
            out = {"image": feats}
            if label_dtype is not None:
                out["label"] = (
                    table[idx, feat_bytes:]
                    .view(np.dtype(label_dtype))
                    .reshape(len(idx))
                )
            yield out
    finally:
        pipe.close()


def _record_batches(
    path, example_shape, dtype, batch_size, label_dtype, seed, shuffle,
    loop, prefetch, threads, engine, crop_hw, augment_train,
    shard_id, num_shards,
) -> Iterator[dict[str, np.ndarray]]:
    from tf_operator_tpu_torch.native.pipeline import RecordPipeline

    if label_dtype is not None:
        label_dtype = np.dtype(label_dtype)
    feat_bytes = int(np.prod(example_shape)) * dtype.itemsize
    rec_bytes = feat_bytes + (
        label_dtype.itemsize if label_dtype is not None else 0
    )
    if crop_hw is not None:
        from tf_operator_tpu_torch.native.augment import augment_records

    pipe = RecordPipeline(
        path, rec_bytes, batch_size, prefetch=prefetch, threads=threads,
        seed=seed, shuffle=shuffle, loop=loop, engine=engine,
        shard_id=shard_id, num_shards=num_shards,
    )
    sample_index = 0
    try:
        for raw in pipe:
            if crop_hw is not None:
                # Strided path: the crop reads image bytes straight out of
                # the raw record rows — no whole-batch slice-and-copy
                # between the loader and the augmenter (record_dataset
                # guarantees uint8 [H,W,C] when crop_hw is set).
                feats = augment_records(
                    raw, example_shape, crop_hw, seed=seed,
                    index0=sample_index, train=augment_train,
                    threads=threads, engine=engine,
                )
                sample_index += len(feats)
            else:
                feats = (
                    raw[:, :feat_bytes]
                    .copy()
                    .view(dtype)
                    .reshape(len(raw), *example_shape)
                )
            out = {"image": feats}
            if label_dtype is not None:
                out["label"] = (
                    raw[:, feat_bytes:].copy().view(label_dtype).reshape(len(raw))
                )
            yield out
    finally:
        pipe.close()


def token_dataset(
    path: str,
    seq_len: int,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    loop: bool = True,
    prefetch: int = 4,
    threads: int = 2,
    engine: str = "auto",
    shard_id: int = 0,
    num_shards: int = 1,
) -> Iterator[dict[str, np.ndarray]]:
    """Stream {tokens, targets} LM batches from a binary token-record file.

    Layout: one fixed-size record per training sequence — (seq_len + 1)
    int32 token ids; tokens = rec[:-1], targets = rec[1:] (next-token
    objective). IO, shuffling and prefetch ride the same native C++
    pipeline as the image path (native/record_pipeline.cc), so the LM
    input side is also off the GIL. Multi-host: pass each process its
    topology slot (shard_id=process_id, num_shards=num_processes) and
    every epoch is dealt disjointly across hosts from ONE shared file.
    """
    base = record_dataset(
        path, (seq_len + 1,), np.int32, batch_size, label_dtype=None,
        seed=seed, shuffle=shuffle, loop=loop, prefetch=prefetch,
        threads=threads, engine=engine, shard_id=shard_id,
        num_shards=num_shards,
    )

    def gen() -> Iterator[dict[str, np.ndarray]]:
        for batch in base:  # record_dataset owns the pipeline lifecycle
            seqs = batch["image"]
            yield {"tokens": seqs[:, :-1], "targets": seqs[:, 1:]}

    return gen()


def write_token_records(path: str, seqs: np.ndarray) -> int:
    """Write [N, seq_len+1] int32 token sequences as the records
    token_dataset reads. Returns the record size in bytes."""
    seqs = np.ascontiguousarray(seqs, dtype=np.int32)
    if seqs.ndim != 2:
        raise ValueError(f"expected [N, seq_len+1] tokens, got {seqs.shape}")
    return write_example_records(path, seqs)


def write_example_records(
    path: str, features: np.ndarray, labels: np.ndarray | None = None
) -> int:
    """Write features (+ labels) as the fixed-size records record_dataset
    reads. Returns the record size in bytes."""
    from tf_operator_tpu_torch.native.pipeline import write_records

    n = len(features)
    feats = np.ascontiguousarray(features).reshape(n, -1)
    rows = feats.view(np.uint8).reshape(n, -1)
    if labels is not None:
        lab = np.ascontiguousarray(labels).reshape(n, -1)
        rows = np.concatenate([rows, lab.view(np.uint8).reshape(n, -1)], axis=1)
    write_records(path, rows)
    return rows.shape[1]


def fill_stacked(
    pipe, image_shape: tuple[int, int, int], images: np.ndarray,
    labels: np.ndarray, *, seed: int, index0: int, threads: int,
) -> int:
    """``bench.py``'s ``next_stacked`` into the caller's buffers: for each
    of ``images``' [steps, B, h, w, C] slots, the next B record indices of
    ``pipe`` (an ``MMapRecordPipeline``; an epoch's short last batch is
    topped up from the next epoch), cropped and flipped by
    the native ``augment_gather`` straight into the slot (a g++ failure
    raises: this path has no Python fallback), with sample indices from
    ``index0`` on; ``labels`` [steps, B] gets each record's trailing label
    byte mod 1000 (ImageNet's classes, as bench.py takes them). Returns the
    next sample index."""
    from tf_operator_tpu_torch.native.augment import augment_gather

    steps, batch, out_h, out_w, _ = images.shape
    for s in range(steps):
        idx = pipe.next_indices()
        while len(idx) < batch:  # final short batch of an epoch
            idx = np.concatenate([idx, pipe.next_indices()])[:batch]
        augment_gather(
            pipe.data, idx, pipe.record_bytes, image_shape, (out_h, out_w),
            seed=seed, index0=index0, threads=threads, engine="native",
            out=images[s],
        )
        index0 += batch
        labels[s] = pipe.labels(idx) % 1000
    return index0
