"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C entry point and no PyTorch
header, so ``nvcc`` builds it in seconds into a shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -I csrc -o _build/<name>-<hash>.so \\
         csrc/<name>.cu

The library is built at first use, named by a hash of its source, of
every header in ``csrc/`` (the sources include them with ``#include
"..."``) and of the flags: an edited source or header builds anew, an
unchanged one is reused. It is loaded with ``ctypes``. ``build`` starts
one ``nvcc`` per source, all at once, and waits for them together.
``_build/`` is listed in ``.gitignore``. Nothing here runs when a module
is imported: the CPU tests import every module on a machine without
``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
# -Xptxas=-v writes each kernel's registers, shared memory and spills
# into the build log beside the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``). Raises ``RuntimeError`` when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA "
            "kernels cannot be built"
        )
    return path


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def sources(name: str) -> list[str]:
    """What the library of ``csrc/<name>.cu`` is built from: the source,
    then every header in ``csrc/`` (an edited header builds every source
    anew, whether or not it includes it)."""
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    return [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in headers]


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives once built: the
    name carries a hash of the flags and of ``sources``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(hashlib.sha256(f.read()).digest())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(*names: str) -> dict[str, str]:
    """Build the named sources that are not built yet, one ``nvcc``
    process each, all started before any is waited on. Returns
    ``{name: library path}``; raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {name: library_path(name) for name in names}
    running = []
    for name, lib in out.items():
        if os.path.exists(lib):
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
               source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in running:
        log, _ = proc.communicate()
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output for the built library (ptxas register and
    shared-memory lines), or '' when it was not built here."""
    path = library_path(name)[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[name])
            _libs[name] = lib
        return lib
