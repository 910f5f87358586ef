"""The port's host C++ (the record pipeline and the augment stage), built
on demand with the system g++: its own copy of
``tf_operator_tpu/native/__init__.py::load_library``.

    g++ -O2 -shared -fPIC -std=c++17 -pthread <source>.cc -o _build/<name>-<hash>.so

The library is named by a digest of its source, so an edited source
builds anew and a stale one is never loaded. Each process builds to a
``mkstemp`` file of its own and publishes it with ``os.replace``: test
workers and replicas may build at once, and the last whole library
wins. A failed build raises ``NativeBuildError``; the Python wrappers
(``native/pipeline.py``, ``native/augment.py``) decide what that means
(``engine="auto"`` falls back to their Python engines, ``"native"``
raises). ``_build/`` is listed in ``.gitignore``. Nothing compiles when a
module is imported. These sources are host code, not CUDA kernels:
``ops/_build.py`` builds the kernels with nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL | None] = {}


class NativeBuildError(RuntimeError):
    pass


def _source_digest(src_path: str) -> str:
    with open(src_path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def load_library(source: str) -> ctypes.CDLL:
    """Compile (if needed) and dlopen a one-file C++ library.

    ``source`` is a filename relative to this package. A build that
    failed once in this process fails again without another g++ run."""
    src_path = os.path.join(_DIR, source)
    key = f"{source}:{_source_digest(src_path)}"
    with _LOCK:
        if key in _CACHE:
            lib = _CACHE[key]
            if lib is None:
                raise NativeBuildError(f"previous build of {source} failed")
            return lib
        so_path = os.path.join(
            BUILD_DIR, f"{os.path.splitext(source)[0]}-{key.split(':')[1]}.so"
        )
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # One tmp file per process: concurrent builds must not
            # interleave writes into one file.
            fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
            os.close(fd)
            cmd = [
                "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                src_path, "-o", tmp,
            ]
            try:
                try:
                    # lint: ok blocking-under-lock — one-shot compile-cache fill; serializing the g++ build is this lock's purpose
                    proc = subprocess.run(
                        cmd, capture_output=True, text=True, timeout=120
                    )
                except (OSError, subprocess.TimeoutExpired) as e:
                    _CACHE[key] = None
                    raise NativeBuildError(f"g++ unavailable: {e}") from e
                if proc.returncode != 0:
                    _CACHE[key] = None
                    raise NativeBuildError(
                        f"compile failed for {source}:\n{proc.stderr[-4000:]}"
                    )
                os.replace(tmp, so_path)
            finally:
                # A failed or timed-out build leaves no .so.tmp behind (a
                # good one was renamed away).
                if os.path.exists(tmp):
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            # A corrupt or wrong-arch binary reads as a build problem, so
            # engine="auto" callers fall back instead of crashing.
            _CACHE[key] = None
            raise NativeBuildError(f"dlopen failed for {so_path}: {e}") from e
        _CACHE[key] = lib
        return lib
