"""Build and binding of the port's hand-written CUDA kernels, and the
one place that finds the CUDA toolkit (``nvcc`` for the kernels of
``csrc/``, ``libnvrtc`` and its headers for ``rtc``).

Each kernel source ``csrc/<name>.cu`` exports a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library,
loaded with ``ctypes``.  This keeps PyTorch's headers out of the build,
which then takes seconds instead of minutes.  Code shared by several
kernels lives in ``csrc/*.cuh`` headers.  Libraries are built at first
use into ``_build/`` beside this file (listed in ``.gitignore``), named
by a hash of the source, the headers and the flags, so an edited source
or header rebuilds and an unchanged one is reused.  Nothing here runs at import
time: the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

from .base import MXNetError

__all__ = ["build", "load", "nvrtc_path", "cuda_include_dirs",
           "BUILD_DIR", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

DEFAULT_CUDA_HOME = "/usr/local/cuda"
DEFAULT_NVCC = os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc")

_lock = threading.Lock()
_libs = {}


def _cuda_home():
    return os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")


def _nvcc():
    home = _cuda_home()
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise MXNetError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of incubator_mxnet_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def nvrtc_path():
    """Path of the NVRTC library, searched in ``$CUDA_HOME/lib64``, then
    ``/usr/local/cuda/lib64``, then the ``nvidia/cuda_nvrtc/lib``
    directory of the torch wheel's install.  Raises MXNetError when
    none holds one."""
    import torch
    home = _cuda_home()
    dirs = [os.path.join(home, "lib64")] if home else []
    dirs += [os.path.join(DEFAULT_CUDA_HOME, "lib64"),
             os.path.join(os.path.dirname(os.path.dirname(torch.__file__)),
                          "nvidia", "cuda_nvrtc", "lib")]
    for d in dirs:
        found = sorted(glob.glob(os.path.join(d, "libnvrtc.so*")),
                       key=len)
        if found:
            return found[0]
    raise MXNetError(
        "libnvrtc not found (searched " + ", ".join(dirs) + "): "
        "rtc.CudaModule compiles CUDA C at run time with NVRTC and needs "
        "the CUDA toolkit or the nvidia-cuda-nvrtc wheel")


def cuda_include_dirs():
    """The CUDA toolkit's include directories that exist
    (``$CUDA_HOME/include``, ``/usr/local/cuda/include``), for NVRTC's
    ``-I`` (``cuda_fp16.h`` for ``__half``)."""
    home = _cuda_home()
    dirs = ([os.path.join(home, "include")] if home else []) + \
        [os.path.join(DEFAULT_CUDA_HOME, "include")]
    return [d for d in dict.fromkeys(dirs) if os.path.isdir(d)]


def _source(name):
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _lib_path(name):
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for path in [_source(name)] + [os.path.join(CSRC_DIR, h)
                                   for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build(names, verbose=False):
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together.  Returns ``{name: compiler log}``
    for the sources compiled by this call (``verbose`` adds ptxas's
    register and shared-memory report to the log).  Raises MXNetError
    naming each source that failed."""
    with _lock:
        return _build_locked(names, verbose)


def _build_locked(names, verbose):
    todo = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
    if not todo:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas=-v"] if verbose else []),
               "-o", tmp, _source(name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                          f"{out[-4000:]}")
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name):
    """The loaded ``ctypes.CDLL`` of kernel ``name``, built first if
    needed.  Raises MXNetError when it cannot be built."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked([name], verbose=False)
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib
