"""ctypes bindings + threaded prefetcher for the native data loader.

Port of ``boxfusion_tpu/native/loader.py``; ``loader.cc`` is a byte-for-byte
copy of the JAX package's.  The shared library is compiled with g++ at first
use (``get_loader``, never at import) into ``boxfusion_tpu_torch/_build/``,
named by a hash of ``loader.cc``, the g++ flags and the compiler's version
and target, as ``ops/build.py`` names the CUDA libraries: an edited source,
other flags or another toolchain build a new library instead of loading a
stale one.

When g++ or the PNG / JPEG headers are missing, ``get_loader()`` returns
None and the readers decode with PIL (``data/readers.py``), as in the JAX
package.  That fallback is visible: ``native_available()`` says whether the
library loaded, and ``build_error()`` keeps the compiler's reason.

The decode/resize entry points release the GIL (plain ctypes calls), so the
``Prefetcher`` gets true multi-threaded frame loading -- the reference's
loader decodes synchronously on the demo thread (capture_stream.py:194-206).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Iterator, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LINK_FLAGS = ("-lpng", "-ljpeg", "-lz")

_loader: Optional["NativeLoader"] = None
_tried = False
_error: Optional[str] = None


def _toolchain() -> str:
    """The compiler's version and target ("" when there is no g++)."""
    try:
        out = subprocess.run(["g++", "-dumpfullversion", "-dumpmachine"], check=True,
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return " ".join(out.stdout.split())


def library_path(toolchain: Optional[str] = None) -> Path:
    """Where the library is built: named by a hash of the source, the flags
    and the toolchain."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    digest.update((_toolchain() if toolchain is None else toolchain).encode())
    return BUILD_DIR / f"libbfloader-{digest.hexdigest()[:12]}.so"


def _build() -> Path:
    """Compile the library if it is missing; raise with the reason if not."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr.strip()}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


class NativeLoader:
    """Thin ctypes wrapper over libbfloader."""

    def __init__(self, so_path: str):
        lib = ctypes.CDLL(str(so_path))
        lib.bf_decode_png.restype = ctypes.c_int
        lib.bf_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.bf_decode_jpeg.restype = ctypes.c_int
        lib.bf_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.bf_resize_rgb_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.bf_resize_f32.argtypes = lib.bf_resize_rgb_u8.argtypes
        lib.bf_free.argtypes = [ctypes.c_void_p]
        self._lib = lib

    def decode_png(self, data: bytes) -> np.ndarray:
        """PNG bytes -> (H, W[, C]) uint8 or uint16 array."""
        out = ctypes.c_void_p()
        w = ctypes.c_int()
        h = ctypes.c_int()
        ch = ctypes.c_int()
        depth = ctypes.c_int()
        rc = self._lib.bf_decode_png(
            data, len(data), ctypes.byref(out), ctypes.byref(w),
            ctypes.byref(h), ctypes.byref(ch), ctypes.byref(depth),
        )
        if rc != 0:
            raise ValueError(f"bf_decode_png failed rc={rc}")
        try:
            dt = np.uint16 if depth.value == 16 else np.uint8
            n = h.value * w.value * ch.value
            arr = np.ctypeslib.as_array(
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)),
                (n * np.dtype(dt).itemsize,),
            ).view(dt)[:n].copy()
        finally:
            self._lib.bf_free(out)
        shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
        return arr.reshape(shape)

    def decode_jpeg(self, data: bytes) -> np.ndarray:
        out = ctypes.c_void_p()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.bf_decode_jpeg(
            data, len(data), ctypes.byref(out), ctypes.byref(w), ctypes.byref(h)
        )
        if rc != 0:
            raise ValueError(f"bf_decode_jpeg failed rc={rc}")
        try:
            n = h.value * w.value * 3
            arr = np.ctypeslib.as_array(
                ctypes.cast(out, ctypes.POINTER(ctypes.c_uint8)), (n,)
            ).copy()
        finally:
            self._lib.bf_free(out)
        return arr.reshape(h.value, w.value, 3)

    def resize_rgb(self, img: np.ndarray, size_wh) -> np.ndarray:
        w, h = size_wh
        if (img.shape[1], img.shape[0]) == (w, h):
            return img
        src = np.ascontiguousarray(img, np.uint8)
        dst = np.empty((h, w, 3), np.uint8)
        self._lib.bf_resize_rgb_u8(
            src.ctypes.data, img.shape[0], img.shape[1], dst.ctypes.data, h, w
        )
        return dst

    def resize_f32(self, img: np.ndarray, size_wh) -> np.ndarray:
        w, h = size_wh
        if (img.shape[1], img.shape[0]) == (w, h):
            return img
        src = np.ascontiguousarray(img, np.float32)
        dst = np.empty((h, w), np.float32)
        self._lib.bf_resize_f32(
            src.ctypes.data, img.shape[0], img.shape[1], dst.ctypes.data, h, w
        )
        return dst


def native_available() -> bool:
    """Whether the native library built and loaded (builds it on first call)."""
    return get_loader() is not None


def build_error() -> Optional[str]:
    """Why the library did not build or load; None when it did (or was not
    tried yet)."""
    return _error


def get_loader() -> Optional[NativeLoader]:
    """Build (once) and return the native loader, or None (see
    ``build_error`` for the reason)."""
    global _loader, _tried, _error
    if _loader is None and not _tried:
        _tried = True
        try:
            _loader = NativeLoader(str(_build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
    return _loader


class Prefetcher:
    """Background-thread frame prefetch over any Frame iterable.

    The reference decodes frames synchronously inside the demo loop; here
    decode/IO overlaps with device compute.
    """

    def __init__(self, iterable: Iterable, depth: int = 4):
        self._it = iter(iterable)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:  # re-raised in the consumer, not swallowed
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise RuntimeError("prefetch producer failed") from self._error
                return
            yield item
