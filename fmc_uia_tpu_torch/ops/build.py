"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries land in ``build/fmc_uia_tpu_torch/`` at
the checkout's root, named by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library. ``build()`` starts one
``nvcc`` per missing library, all at once; a failure raises with nvcc's
output. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fmc_uia_tpu_torch"
KERNELS = ("swin_attn_fwd", "swin_mlp_fwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_VP, _I = ctypes.c_void_p, ctypes.c_int
# C signature (argtypes) of each library's entry point; all return an int
# CUDA error code
SIGNATURES = {
    "swin_attn_fwd": [_VP] * 12 + [ctypes.c_float] + [_I] * 7 + [_VP],
    "swin_mlp_fwd": [_VP] * 9 + [ctypes.c_longlong] + [_I] * 4 + [_VP],
}

_libs: Dict[str, Callable[..., int]] = {}


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


def load(name: str):
    """The entry point ``name`` of its library, built on first use, with
    its ctypes signature set."""
    fn = _libs.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(lib_path(name))), name)
        fn.restype = ctypes.c_int
        fn.argtypes = SIGNATURES[name]
        _libs[name] = fn
    return fn
