"""Build and load the hand-written CUDA kernels (``csrc/*.cu``) and the
host image helper (``csrc/host_image.cpp``).

Each CUDA source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The host helper is plain C++ built by
``g++`` (which nvcc itself needs) the same way. Libraries land in
``build/fmc_uia_tpu_torch/`` at the checkout's root, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged tree reuses the
library. ``build()`` starts one ``nvcc`` per missing library, all at once;
a failure raises with the compiler's output. Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fmc_uia_tpu_torch"
KERNELS = ("swin_attn_fwd", "swin_mlp_fwd", "swin_attn_bwd",
           "swin_mlp_bwd", "preprocess_fwd", "vit_flash_fwd",
           "vit_flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _LLP = ctypes.c_float, ctypes.POINTER(ctypes.c_longlong)
_U8P, _IP = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
# C signature (argtypes) of each exported function. A library's entry
# point is named after it and returns an int CUDA error code; a
# ``*_workspace`` function returns the bytes of scratch its entry point
# needs.
SIGNATURES = {
    "swin_attn_fwd": [_VP] * 12 + [ctypes.c_float] + [_I] * 7 + [_VP],
    "swin_attn_fwd_workspace": [_I] * 7,
    "swin_mlp_fwd": [_VP] * 3 + [_LL] + [_VP] * 7 + [_LL] + [_I] * 4 + [_VP],
    "swin_mlp_fwd_workspace": [_LL] + [_I] * 3,
    "swin_attn_bwd": [_VP] * 20 + [ctypes.c_float] + [_I] * 9 + [_VP],
    "swin_attn_bwd_workspace": [_I] * 9,
    "swin_mlp_bwd": [_VP] * 17 + [_LL, _LL] + [_I] * 6 + [_VP],
    "swin_mlp_bwd_workspace": [_LL] + [_I] * 5,
    "preprocess_fwd": [_VP] * 6 + [_I, _I, _LL, _I, _IP, _VP],
    # tensors, then a host array of (b, h, n) element strides per tensor
    "vit_flash_fwd": [_VP] * 5 + [_LLP, _F] + [_I] * 5 + [_VP],
    "vit_flash_bwd": [_VP] * 10 + [_LLP, _F] + [_I] * 5 + [_VP],
    "vit_flash_bwd_workspace": [_I] * 3,
}
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
# (restype, argtypes) of the host helper's functions
HOST_SIGNATURES = {
    "resize_bilinear_u8": (None, [_U8P, _I, _I, _I, _U8P, _I, _I]),
    "resize_nearest_u8": (None, [_U8P, _I, _I, _I, _U8P, _I, _I]),
    "resize_batch_u8": (None, [ctypes.POINTER(_U8P), _IP, _IP, _I, _U8P,
                               _I, _I, _I, _I, _I]),
    "png_unfilter": (ctypes.c_int, [ctypes.c_char_p, _U8P, _I, _LL, _I]),
}

_libs: Dict[str, Callable[..., int]] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}
_host_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda)")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def host_lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The host library ``csrc/<name>.cpp``, built by ``g++`` on first use
    (thread-safe; a failed build raises with g++'s output), with the
    ctypes signatures of ``HOST_SIGNATURES`` set."""
    with _host_lock:
        lib = _host_libs.get(name)
        if lib is not None:
            return lib
        out = host_lib_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: cannot build {name}.cpp")
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            p = subprocess.run([gxx, *HOST_FLAGS, str(CSRC / f"{name}.cpp"),
                                "-o", str(tmp)], capture_output=True,
                               text=True)
            if p.returncode != 0:
                raise RuntimeError(f"g++ {name}.cpp failed (exit "
                                   f"{p.returncode}):\n{p.stdout}{p.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for fn, (res, args) in HOST_SIGNATURES.items():
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        _host_libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output (registers, shared memory, spills)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel; returns seconds spent
    on each one built (an empty dict when all were built already)."""
    names = list(names or KERNELS)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = lib_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    spent, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        spent[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {p.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return spent


def load(name: str, symbol: Optional[str] = None):
    """The function ``symbol`` (default: the entry point ``name``) of the
    library ``name``, built on first use, with its ctypes signature set."""
    symbol = symbol or name
    fn = _libs.get(symbol)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(lib_path(name))), symbol)
        fn.restype = (_LL if symbol.endswith("_workspace")
                      else ctypes.c_int)
        fn.argtypes = SIGNATURES[symbol]
        _libs[symbol] = fn
    return fn
