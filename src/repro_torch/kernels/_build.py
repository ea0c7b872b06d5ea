"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain C launch function and is compiled
on its own into a shared library under ``<repo>/build/kernels`` (listed in
``.gitignore``), named by a hash of its source, of every ``csrc`` header it
includes (``#include "..."``, followed through headers) and of its flags,
so an edited source or header rebuilds and an unchanged one is reused.
Builds start together, one ``nvcc`` process per source.  Nothing here runs at import time: the
CPU tests import every module of the port, and this machine may have no
``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Per-kernel flags.  The hardware-path kernels (pdu_health, lc_filter,
# pdu_sim) pin rounding (-fmad=false; the fused multiply-adds they need are
# explicit __fmaf_rn), so each matches its plain version bit for bit; the
# others keep nvcc's FP32 FMA contraction.
SOURCES = {
    "pdu_health": ("pdu_health.cu", ["-fmad=false"]),
    "lc_filter": ("lc_filter.cu", ["-fmad=false"]),
    "pdu_sim": ("pdu_sim.cu", ["-fmad=false"]),
    "gemm_burn": ("gemm_burn.cu", []),
    "admm_step": ("admm_step.cu", []),
    "rmsnorm": ("rmsnorm.cu", []),
    "flash_attention": ("flash_attention.cu", []),
    "flash_attention_bwd": ("flash_attention_bwd.cu", []),
    "rwkv6_scan": ("rwkv6_scan.cu", []),
    # Not a port of a TPU kernel: the dependent-FMA latency probe that
    # chip_smoke.py's chain bound reads, in a library of its own.
    "fma_chain": ("fma_chain.cu", []),
}

_loaded: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
build_logs: dict[str, str] = {}  # nvcc/ptxas output of this process's builds


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(src: str) -> list[Path]:
    """``src`` and every file under ``csrc`` it includes with quotes,
    directly or through another such header, each once, in the order met."""
    seen: list[Path] = []
    todo = [_CSRC / src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / inc.decode()).resolve()
            if dep.is_relative_to(_CSRC.resolve()):
                todo.append(dep)
    return seen


def _lib_path(name: str) -> Path:
    src, flags = SOURCES[name]
    h = hashlib.sha256()
    for path in _sources(src):
        h.update(path.read_bytes())
    h.update(" ".join(_ARCH + _COMMON + flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once; raise with the compiler output if any fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n in names:
        if paths[n].exists():
            continue
        src, flags = SOURCES[n]
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_ARCH, *_COMMON, *flags, "-o", str(tmp), str(_CSRC / src)]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def launch_fn(name: str, symbol: str, argtypes: list):
    """The C launch function ``symbol`` of kernel ``name`` with its ctypes
    signature set (returns the CUDA error code), cached per symbol."""
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
