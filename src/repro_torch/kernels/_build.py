"""Build and load the port's CUDA kernels (``csrc/*.cu``) for ``sm_90a``.

The build runs at the first CUDA call, never at import, so the package
imports on machines without ``nvcc``. Output goes to ``build/kernels/`` at
the root of the checkout (listed in ``.gitignore``).

Route: ``torch.utils.cpp_extension.load`` over all sources in one call,
with PyTorch's headers confined to ``csrc/binding.cpp``; where ``ninja``
(which ``load`` needs) is missing, ``nvcc`` compiles the kernel sources
into a shared library with a plain C interface, loaded with ``ctypes``.
Either way the returned object exposes ``restore_kv_grouped``,
``decode_attention``, ``decode_attention_paged``, ``flash_attention`` and
``ssm_update`` taking device addresses and sizes as Python numbers, and
raises when a launch fails.
"""
from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("restore_kv.cu", "decode_attention.cu",
                  "flash_attention.cu", "ssm_update.cu")
ARCH_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-O3", "-std=c++17", "-lineinfo"] + ARCH_FLAGS

# seconds the last build took (set by ``library``; read by chip_smoke.py)
build_seconds = 0.0

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    "hc_restore_kv_grouped": [_VP] * 10 + [_I] * 12 + [_VP],
    "hc_decode_attention": [_VP] * 10 + [_I] * 5 + [_LL] * 6
    + [_F, _F] + [_I] * 4 + [_VP],
    "hc_decode_attention_paged": [_VP] * 9 + [_I] * 7 + [_LL] * 6
    + [_F, _F] + [_I] * 4 + [_VP],
    "hc_flash_attention": [_VP] * 8 + [_I] * 6 + [_LL] * 9
    + [_F, _F] + [_I] * 11 + [_VP],
    "hc_ssm_update": [_VP] * 9 + [_I] * 4 + [_LL] * 10 + [_I] * 3 + [_VP],
}


class _CtypesKernels:
    """Route (b): the same call surface as the ``load`` extension."""

    def __init__(self, path: pathlib.Path):
        self._lib = ctypes.CDLL(str(path))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(self._lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc < 0:
            raise RuntimeError(f"{name}: unsupported shape or dtype")
        if rc:
            raise RuntimeError(f"{name}: launch failed with CUDA error {rc}")

    def restore_kv_grouped(self, *args) -> None:
        self._call("hc_restore_kv_grouped", *args)

    def decode_attention(self, *args) -> None:
        self._call("hc_decode_attention", *args)

    def decode_attention_paged(self, *args) -> None:
        self._call("hc_decode_attention_paged", *args)

    def flash_attention(self, *args) -> None:
        self._call("hc_flash_attention", *args)

    def ssm_update(self, *args) -> None:
        self._call("hc_ssm_update", *args)


def _build_with_nvcc() -> _CtypesKernels:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: cannot build the kernels")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    objs, procs = [], []
    for src in KERNEL_SOURCES:       # one nvcc per source, all at once
        obj = BUILD_DIR / (src + ".o")
        objs.append(str(obj))
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c",
             str(CSRC / src), "-o", str(obj)]))
    for src, p in zip(KERNEL_SOURCES, procs):
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on {src}")
    lib = BUILD_DIR / "libhcache_kernels.so"
    subprocess.run([nvcc, "-shared", *objs, "-o", str(lib)], check=True)
    return _CtypesKernels(lib)


@functools.lru_cache(maxsize=None)
def library():
    """The compiled kernels, built on first use."""
    global build_seconds
    import torch.utils.cpp_extension as cpp
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    if cpp.is_ninja_available():
        lib = cpp.load(
            name="hcache_kernels",
            sources=[str(CSRC / "binding.cpp")]
            + [str(CSRC / s) for s in KERNEL_SOURCES],
            build_directory=str(BUILD_DIR),
            extra_cflags=["-O2"],
            extra_cuda_cflags=NVCC_FLAGS,
            verbose=False)
    else:
        lib = _build_with_nvcc()
    build_seconds = time.perf_counter() - t0
    return lib
