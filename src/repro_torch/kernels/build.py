"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions and is compiled on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root the first
time a kernel is needed; the hash covers the source, every shared header
``csrc/*.cuh`` and the nvcc flags, so an edited source or header is rebuilt.
``build_all`` starts one nvcc per source at once.
Nothing here runs at import time: this module imports on machines without
the CUDA toolkit, and only a call that launches a kernel needs nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("decode_attention", "decode_attention_paged", "flash_attention",
           "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")
# head dims the attention kernels (K1-K3) are instantiated at; 120 runs at a
# tile width of 128 (csrc/attention_tile.cuh)
HEAD_DIMS = (32, 64, 120, 128)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc():
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name):
    """Where ``csrc/<name>.cu`` is built."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build_all(names=KERNELS):
    """Compile every named source that is not built yet, all nvcc processes
    running at once.  Returns each compiled kernel's compiler log (ptxas
    register and shared-memory report); raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def check_inputs(kernel, q, floats, ints=()):
    """Refuse what a kernel cannot take: every tensor contiguous on q's CUDA
    device, the float tensors all float32 or all bfloat16, the int tensors
    int32.  Returns the kernel's dtype code (0 = float32, 1 = bfloat16)."""
    for t in (q, *floats, *ints):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{kernel}: every tensor must be on q's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: every tensor must be contiguous")
    codes = {"torch.float32": 0, "torch.bfloat16": 1}
    if str(q.dtype) not in codes or any(t.dtype != q.dtype for t in floats):
        raise TypeError(f"{kernel}: q, k and v must all be float32 or all bfloat16")
    if any(str(t.dtype) != "torch.int32" for t in ints):
        raise TypeError(f"{kernel}: lengths and positions must be int32")
    return codes[str(q.dtype)]


@functools.lru_cache(maxsize=None)
def route(name, dtype):
    """1 if the C entry point of ``csrc/<name>.cu`` sends this dtype code to
    its bf16 tensor-core kernel (its ``<name>_route``), else 0."""
    return load(name, [ctypes.c_int], f"{name}_route")(dtype)


def launch(wrapper, name, argtypes, dtype, stream, *args, symbol=None):
    """Call the C entry point ``symbol`` (default ``name``) of
    ``csrc/<name>.cu`` on ``args``, the dtype code and the stream; raise if
    it returns a CUDA error, else count the launch on ``wrapper``
    (``launches``, and ``wgmma_launches`` where the dtype goes to the bf16
    tensor-core kernel)."""
    err = load(name, argtypes, symbol)(*args, dtype, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    wrapper.wgmma_launches += route(name, dtype)


def load(name, argtypes, symbol=None):
    """The C function ``symbol`` (default ``name``) of ``csrc/<name>.cu``,
    built if needed, with its argument types declared (pointers and the
    stream as c_void_p) and an int result."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, symbol or name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
