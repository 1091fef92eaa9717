"""Build and load the CUDA kernels of ``atropos_tpu_torch/csrc``.

Each ``*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, in the package's ``build/`` directory,
the first time one of its kernels is launched, and loaded with ``ctypes``.
Nothing is compiled when a module is imported. A failed build raises with
the compiler's output; there is no other implementation to turn to.
"""
import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs = {}
_lock = threading.Lock()


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, under ``CUDA_HOME`` or under
    ``/usr/local/cuda``. Raises when there is none."""
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, under CUDA_HOME and under "
        "/usr/local/cuda): the CUDA kernels cannot be built"
    )


def library_path(name):
    return os.path.join(BUILD_DIR, "lib{}.so".format(name))


def build(name, verbose=False):
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` and return
    (path, compiler output). ``verbose`` adds ptxas' register and
    shared-memory report."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "{}.{}.tmp".format(out, os.getpid())
    cmd = [find_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, src]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(
            "nvcc failed for {}:\n{}\n{}".format(src, done.stdout, done.stderr)
        )
    os.replace(tmp, out)
    return out, done.stdout + done.stderr


def _sources_mtime(name):
    """The newest modification time of ``csrc/<name>.cu`` and the headers
    of ``csrc`` it may include."""
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR) if f.endswith(".h")]
    return max(os.path.getmtime(p) for p in [os.path.join(CSRC_DIR, name + ".cu")] + headers)


def load(name):
    """The ``ctypes`` library of ``csrc/<name>.cu``, built on first use
    (and again when the source or a header of ``csrc`` is newer than the
    library)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = library_path(name)
                if not os.path.exists(path) or os.path.getmtime(path) < _sources_mtime(name):
                    build(name)
                lib = ctypes.CDLL(path)
                _libs[name] = lib
    return lib
