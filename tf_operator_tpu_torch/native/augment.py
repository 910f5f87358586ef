"""Batch image augmentation: random/center crop + horizontal flip (uint8).
The port's own copy of ``tf_operator_tpu/native/augment.py``, with the
same names and semantics; it logs through the standard ``logging``
module.

Python binding for augment.cc with a pure-NumPy fallback of IDENTICAL
semantics — per-image decisions derive from the shared splitmix64 stream
(seed * 1000003 + global_index), so the two engines are bit-interchangeable
and tests assert exact equivalence. Together with RecordPipeline this is
the host half of the input path: records -> shuffle -> crop/flip -> uint8
batch -> device (normalization happens on device; bytes stay uint8 on the
host and over the transfer).
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from tf_operator_tpu_torch.native import NativeBuildError, load_library
from tf_operator_tpu_torch.native.pipeline import _splitmix64_stream

LOG = logging.getLogger(__name__)

_lib = None
_lib_failed = False


def _native_lib():
    global _lib, _lib_failed
    if _lib is None and not _lib_failed:
        try:
            lib = load_library("augment.cc")
            lib.aug_batch.restype = ctypes.c_int
            lib.aug_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64,
            ]
            lib.aug_gather.restype = ctypes.c_int
            lib.aug_gather.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        except NativeBuildError as e:
            LOG.warning("native augment unavailable (%s); numpy engine", e)
            _lib_failed = True
    return _lib


# Domain separator (must match augment.cc): keeps augment decision streams
# disjoint from the record-pipeline shuffle streams, which key the same
# splitmix64 keyspace as seed*1000003+epoch.
_AUGMENT_DOMAIN = 0x6175676D656E7400  # "augment\0"
_MASK64 = (1 << 64) - 1


def _decisions(seed: int, index: int, max_y: int, max_x: int,
               train: bool) -> tuple[int, int, bool]:
    if not train:
        return max_y // 2, max_x // 2, False
    rng = _splitmix64_stream(((seed * 1000003 + index) & _MASK64) ^ _AUGMENT_DOMAIN)
    y = next(rng) % (max_y + 1) if max_y else 0
    x = next(rng) % (max_x + 1) if max_x else 0
    return y, x, bool(next(rng) & 1)


def augment_batch(
    images: np.ndarray,
    out_hw: tuple[int, int],
    *,
    seed: int = 0,
    index0: int = 0,
    train: bool = True,
    threads: int = 4,
    engine: str = "auto",
) -> np.ndarray:
    """Crop + flip: random crop with random hflip when ``train``; a
    deterministic center crop with NO flip otherwise.

    images: [n, H, W, C] uint8 (C-contiguous). index0 is the global index of
    images[0] in the sample stream — it keys the per-image RNG so results
    are reproducible across batch boundaries and engines.
    """
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected [n,H,W,C] uint8, got {images.dtype} {images.shape}")
    n, in_h, in_w, ch = images.shape
    images = np.ascontiguousarray(images)
    return _augment(
        images, n, in_h, in_w, ch, in_h * in_w * ch, out_hw,
        seed=seed, index0=index0, train=train, threads=threads,
        engine=engine,
    )


def augment_records(
    records: np.ndarray,
    image_shape: tuple[int, int, int],
    out_hw: tuple[int, int],
    *,
    seed: int = 0,
    index0: int = 0,
    train: bool = True,
    threads: int = 4,
    engine: str = "auto",
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Crop + flip directly from a raw record batch ([n, record_bytes]
    uint8, each record = H*W*C image bytes + trailing metadata such as a
    label byte). Skips the slice-and-reshape that materializes a full image
    batch copy between the record loader and the augmenter — the per-image
    record stride goes straight into the native kernel. Identical output to
    ``augment_batch(records[:, :H*W*C].reshape(n,H,W,C), ...)``.
    """
    if records.dtype != np.uint8 or records.ndim != 2:
        raise ValueError(
            f"expected [n, record_bytes] uint8, got {records.dtype} "
            f"{records.shape}"
        )
    in_h, in_w, ch = image_shape
    img_bytes = in_h * in_w * ch
    n, rec_bytes = records.shape
    if rec_bytes < img_bytes:
        raise ValueError(
            f"record_bytes {rec_bytes} < image bytes {img_bytes}"
        )
    records = np.ascontiguousarray(records)
    return _augment(
        records, n, in_h, in_w, ch, rec_bytes, out_hw,
        seed=seed, index0=index0, train=train, threads=threads,
        engine=engine, out=out,
    )


def augment_gather(
    base: np.ndarray,
    indices: np.ndarray,
    record_stride: int,
    image_shape: tuple[int, int, int],
    out_hw: tuple[int, int],
    *,
    seed: int = 0,
    index0: int = 0,
    train: bool = True,
    threads: int = 4,
    engine: str = "auto",
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Crop + flip gathering records straight out of ``base`` (a flat uint8
    buffer, typically an ``np.memmap`` of the record file): image i lives at
    ``base[indices[i] * record_stride:]``. The zero-copy host input path —
    for a page-cache-resident file the only byte movement per image is the
    crop write. Decision stream identical to the other entry points
    (per-image key = seed, index0 + i)."""
    if base.dtype != np.uint8 or base.ndim != 1:
        raise ValueError(f"base must be flat uint8, got {base.dtype} {base.shape}")
    in_h, in_w, ch = image_shape
    img_bytes = in_h * in_w * ch
    if record_stride < img_bytes:
        raise ValueError(f"record_stride {record_stride} < image bytes {img_bytes}")
    idx = np.ascontiguousarray(indices, dtype=np.uint64)
    n = int(idx.shape[0])
    if n and int(idx.max()) * record_stride + img_bytes > base.size:
        raise ValueError("index out of range for base buffer")
    out_h, out_w = out_hw
    if out_h > in_h or out_w > in_w:
        raise ValueError(f"crop {out_hw} larger than input {(in_h, in_w)}")
    out = _validate_out(out, n, out_h, out_w, ch)
    lib = _resolve_engine(engine)
    if lib is not None:
        rc = lib.aug_gather(
            base.ctypes.data_as(ctypes.c_char_p),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.c_char_p),
            n, record_stride, in_h, in_w, ch, out_h, out_w,
            seed, index0, int(train), threads,
        )
        if rc != 0:
            raise ValueError(f"aug_gather failed with rc={rc}")
        return out
    for i in range(n):
        y, x, flip = _decisions(seed, index0 + i, in_h - out_h, in_w - out_w, train)
        off = int(idx[i]) * record_stride
        img = base[off:off + img_bytes].reshape(in_h, in_w, ch)
        crop = img[y:y + out_h, x:x + out_w]
        out[i] = crop[:, ::-1] if flip else crop
    return out


def _validate_out(
    out: np.ndarray | None, n: int, out_h: int, out_w: int, ch: int
) -> np.ndarray:
    """Allocate the output batch, or validate a caller-provided buffer
    (writing through one — e.g. a slot of a stacked multi-step batch —
    skips a whole-output copy per batch)."""
    if out is None:
        return np.empty((n, out_h, out_w, ch), np.uint8)
    if (out.shape != (n, out_h, out_w, ch) or out.dtype != np.uint8
            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"out must be C-contiguous uint8 {(n, out_h, out_w, ch)}, got "
            f"{out.dtype} {out.shape}"
        )
    return out


def _resolve_engine(engine: str):
    """The native library to use, or None for the numpy fallback."""
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    lib = _native_lib() if engine in ("auto", "native") else None
    if engine == "native" and lib is None:
        raise NativeBuildError("native augment engine unavailable")
    return lib


def _augment(
    src: np.ndarray, n: int, in_h: int, in_w: int, ch: int, in_stride: int,
    out_hw: tuple[int, int], *, seed: int, index0: int, train: bool,
    threads: int, engine: str, out: np.ndarray | None = None,
) -> np.ndarray:
    out_h, out_w = out_hw
    if out_h > in_h or out_w > in_w:
        raise ValueError(f"crop {out_hw} larger than input {(in_h, in_w)}")
    out = _validate_out(out, n, out_h, out_w, ch)
    lib = _resolve_engine(engine)
    if lib is not None:
        rc = lib.aug_batch(
            src.ctypes.data_as(ctypes.c_char_p),
            out.ctypes.data_as(ctypes.c_char_p),
            n, in_h, in_w, ch, out_h, out_w, seed, index0,
            int(train), threads, in_stride,
        )
        if rc != 0:
            raise ValueError(f"aug_batch failed with rc={rc}")
        return out

    flat = src.reshape(n, -1)
    for i in range(n):
        y, x, flip = _decisions(seed, index0 + i, in_h - out_h, in_w - out_w, train)
        img = flat[i, : in_h * in_w * ch].reshape(in_h, in_w, ch)
        crop = img[y:y + out_h, x:x + out_w]
        out[i] = crop[:, ::-1] if flip else crop
    return out
