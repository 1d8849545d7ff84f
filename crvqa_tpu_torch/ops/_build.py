"""Build-at-first-use for the port's native code.

CUDA sources under `crvqa_tpu_torch/csrc/` are compiled with `nvcc` for
`sm_90a` into plain-C shared libraries and loaded with ctypes (no PyTorch
headers, so a build takes seconds). Host C++ (native/feature_store.cpp) goes
through the same stale-check. Outputs land in `crvqa_tpu_torch/build/`
(gitignored). A library is rebuilt when its source or a `csrc/*.cuh` header
is newer, written under a
temporary name and renamed into place atomically, so concurrent builds
never load a half-written file.

Nothing here runs at import: a kernel's library is built by the first call
that launches it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per library: builds overlap
_loaded: dict[str, ctypes.CDLL] = {}


def build_library(src: str, lib_name: str, command: list[str]) -> str:
    """Compile `src` into BUILD_DIR/lib_name with `command + [src, "-o",
    out]` when the library is missing or older than its source. The
    compiler's output (for nvcc: `-Xptxas -v` register and shared-memory
    use) is kept beside the library as `<lib_name>.log`. Returns the path."""
    lib = os.path.join(BUILD_DIR, lib_name)
    newest = max([os.path.getmtime(src)]
                 + [os.path.getmtime(os.path.join(CSRC_DIR, h))
                    for h in os.listdir(CSRC_DIR) if h.endswith(".cuh")])
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([*command, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {lib_name} from {src} failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        with open(lib + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def nvcc_path() -> str:
    """nvcc from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels are built "
                       "with it at first use")


def load_cuda_library(name: str) -> ctypes.CDLL:
    """Build (if stale) and load `csrc/<name>.cu` as `lib<name>.so`; one
    load per process. Different libraries build concurrently."""
    with _lock:
        name_lock = _locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_library(os.path.join(CSRC_DIR, name + ".cu"),
                                 f"lib{name}.so", [nvcc_path(), *NVCC_FLAGS])
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
