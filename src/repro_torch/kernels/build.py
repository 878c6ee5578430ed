"""Build and load the Hopper kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/kernels/`` at the
repository root, on first use, and loaded with ``ctypes``.  A library's
file name carries a digest of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and a stale library is never loaded.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points per source: name -> argtypes (every one returns the
# launch's cudaError_t as an int).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "quant_pack": {
        "quant_pack": (_P, _I, _P, _P, _I, _I, _I, _I, _P)},
    "dequant_unpack": {
        "dequant_unpack": (_P, _P, _P, _I, _I, _I, _I, _I, _P)},
    "paged_attention": {
        "paged_attention": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "paged_attention_arena": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _F, _P),
        "paged_attention_arena_window_cap": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
            _I, _I, _I, _I, _F, _I, _F, _P)},
    "paged_verify_attention": {
        "paged_verify_attention": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                   _P),
        "paged_verify_attention_arena": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, _I, _F, _P),
        "paged_verify_attention_arena_window_cap": (
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
            _I, _I, _I, _I, _I, _F, _I, _F, _P)},
    "decode_attention": {
        "decode_attention": (_P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I,
                             _I, _I, _I, _I, _I, _I, _F, _P)},
    "hadamard": {
        "hadamard": (_P, _I, _F, _P, _I, _L, _I, _P)},
    "paged_mla_attention": {
        "paged_mla_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _I, _I, _F, _P)},
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source in parallel.  Returns ``{name: ptxas report}`` for
    the libraries built by this call; raises on any compiler failure."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{out}")
            continue
        tmp.replace(library_path(n))
        reports[n] = out
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def timed_build() -> Dict[str, object]:
    """Build every kernel library; returns the seconds taken and the
    ptxas reports (empty when all were already built)."""
    t0 = time.perf_counter()
    reports = build_all()
    for n in SIGNATURES:
        load(n)
    return {"seconds": time.perf_counter() - t0, "reports": reports}
