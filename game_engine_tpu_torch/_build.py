"""Build csrc/ at first use and load it with ctypes.

The CUDA rollout kernel is compiled by nvcc for sm_90a into a shared
library with a plain C interface; the host harness (the kernel's per-room
body, compiled by g++) serves the CPU tests. Both land in build/kernels/ at
the repository root, named by a hash of their sources, so an unchanged
source is built once. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kernels")
_HEADER = os.path.join(_CSRC, "room_step.cuh")

_P = ctypes.c_void_p
_I = ctypes.c_int
# game, game_len, bools, nums, strs, pdict, odict, present, regs, scal, eps,
# B, num_steps, auto_reset
_ROLLOUT_ARGS = [_P, _I] + [_P] * 9 + [ctypes.c_int64, _I, _I]


def _compile(src: str, stem: str, cmd_prefix: list) -> str:
    """Compile `src` (+ the shared header) into BUILD_DIR once per source
    hash; returns the library path."""
    digest = hashlib.sha256()
    for path in (src, _HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(cmd_prefix).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = cmd_prefix + ["-I", _CSRC, src, "-o", tmp]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n{proc.stderr}")
    # keep the compiler's report (nvcc: -Xptxas -v registers/spills)
    with open(so[:-3] + ".log", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, so)
    return so


def _nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


@functools.lru_cache(maxsize=None)
def cuda_lib() -> ctypes.CDLL:
    """csrc/rollout.cu built with nvcc for sm_90a, loaded."""
    so = _compile(os.path.join(_CSRC, "rollout.cu"), "librollout", [
        _nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ])
    lib = ctypes.CDLL(so)
    lib.ge_rollout.restype = _I
    lib.ge_rollout.argtypes = _ROLLOUT_ARGS + [_I, _P]  # threads, stream
    lib.ge_limits.restype = None
    lib.ge_limits.argtypes = [_P]
    lib.ge_error_string.restype = ctypes.c_char_p
    lib.ge_error_string.argtypes = [_I]
    return lib


@functools.lru_cache(maxsize=None)
def host_lib() -> ctypes.CDLL:
    """csrc/rollout_host.cpp (the kernel's per-room body) built with g++."""
    so = _compile(os.path.join(_CSRC, "rollout_host.cpp"), "librollout_host", [
        "g++", "-O2", "-std=c++17", "-shared", "-fPIC",
    ])
    lib = ctypes.CDLL(so)
    lib.ge_rollout_host.restype = _I
    lib.ge_rollout_host.argtypes = _ROLLOUT_ARGS
    lib.ge_limits.restype = None
    lib.ge_limits.argtypes = [_P]
    return lib


def build_log(lib: ctypes.CDLL) -> str:
    """The compiler's report saved beside a library built here."""
    with open(lib._name[:-3] + ".log") as f:
        return f.read()
