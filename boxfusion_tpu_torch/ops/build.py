"""Build the package's CUDA kernels with nvcc, at first use.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds,
not minutes).  Libraries go to ``boxfusion_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the headers under ``csrc/``
and the flags, so an edited source or header is rebuilt and an unchanged one
is reused.  ``build_all`` starts one nvcc per source, all at once, and waits
for them together.

Flags, per source: all get sm_90a (Hopper), -O3 and IEEE division and square
root (nvcc's default without --use_fast_math).  The fitness kernel and the
PST search kernel (which runs the same body, csrc/fitness_body.cuh) also get
-fmad=false, so that every multiply and add rounds on its own as in the plain
PyTorch twin and in the TPU kernel they replace -- the hull and clip tests
compare against tolerances of 2e-5 x magnitude, where a fused multiply-add
moves a boundary decision.  The two attention kernels are held to a
tolerance, not to bit equality, and keep nvcc's default FMA contraction.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "fitness_kernel": "fitness_kernel.cu",
    "pst_search_kernel": "pst_search_kernel.cu",
    "attention_kernel": "attention_kernel.cu",
    "tiled_attention_kernel": "tiled_attention_kernel.cu",
}

_COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# kernel library name -> nvcc flags (part of the library's hash)
NVCC_FLAGS: Dict[str, Tuple[str, ...]] = {
    "fitness_kernel": _COMMON_FLAGS + ("-fmad=false", "-Xptxas", "-v"),
    "pst_search_kernel": _COMMON_FLAGS + ("-fmad=false", "-Xptxas", "-v"),
    "attention_kernel": _COMMON_FLAGS + ("-Xptxas", "-v"),
    "tiled_attention_kernel": _COMMON_FLAGS + ("-Xptxas", "-v"),
}


@dataclasses.dataclass
class Build:
    """One compiled kernel library: where it is, what nvcc said, how long."""

    name: str
    path: Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str        # nvcc / ptxas output (registers, spills), "" when reused


_LOADED: Dict[str, ctypes.CDLL] = {}  # process-wide: a .so is loaded once


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels of "
            "boxfusion_tpu_torch are built from csrc/ at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library ``name`` is built: named by a hash of its source,
    every header under csrc/ (a source may include any of them) and its flags."""
    digest = hashlib.sha256((CSRC_DIR / SOURCES[name]).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS[name]).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Build]:
    """Compile every named kernel library that is missing, in parallel.

    Raises RuntimeError with the compiler's output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    builds: Dict[str, Build] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            builds[name] = Build(name, out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS[name], "-o", str(tmp), str(CSRC_DIR / SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        builds[name] = Build(name, out, seconds, log)
    return builds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build = build_all([name])[name]
        lib = ctypes.CDLL(str(build.path))
        _LOADED[name] = lib
    return lib
