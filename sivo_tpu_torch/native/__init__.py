"""ctypes bindings for the native runtime library (port of the JAX
package's ``native``; ``sivo_native.cpp`` here is a byte-equal copy of
its source): the DBoW text vocabulary parser and the C++ inverted file.

The library is compiled on first use by the host C++ compiler (``c++
-O2 -fPIC -shared -std=c++17``) into ``build/sivo_tpu_torch/`` at the
root of the checkout, named by a hash of the source and the flags, as
``utils/kernels.py`` does for the CUDA kernels; nothing is built at
import time. ``available()`` is False when no compiler is found or the
build fails, and callers then take their pure-Python paths.
``PARSES`` counts the vocabularies the native parser has read.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from sivo_tpu_torch.utils.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "sivo_native.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17")
PARSES = 0


def compiler() -> str | None:
    """Path of the host C++ compiler: $CXX, then c++, then g++."""
    for name in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    return None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libsivo_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if the one for the current source is missing
    (a temporary name, then an atomic rename, so concurrent builders do
    not collide). Raises RuntimeError without a compiler or on a failed
    compile."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


@functools.cache
def _load() -> ctypes.CDLL | None:
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.TimeoutExpired):
        return None
    lib.voc_count_nodes.restype = ctypes.c_int64
    lib.voc_count_nodes.argtypes = [ctypes.c_char_p]
    lib.voc_parse.restype = ctypes.c_int
    lib.voc_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.invfile_create.restype = ctypes.c_void_p
    lib.invfile_create.argtypes = [ctypes.c_int64]
    lib.invfile_destroy.restype = None
    lib.invfile_destroy.argtypes = [ctypes.c_void_p]
    for name in ("invfile_add", "invfile_erase"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                       ctypes.c_int64]
    lib.invfile_shared_counts.restype = None
    lib.invfile_shared_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    return lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native library could not be built")
    return lib


def parse_vocabulary_text(path: str):
    """DBoW2 text vocabulary -> (k, depth, parents, leaf_flags,
    descriptors (n, 32) uint8, weights), one streaming pass in C++."""
    global PARSES
    lib = _library()
    n = lib.voc_count_nodes(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    parents = np.zeros(n, np.int32)
    leaf = np.zeros(n, np.uint8)
    desc = np.zeros((n, 32), np.uint8)
    weights = np.zeros(n, np.float32)
    k = ctypes.c_int32()
    depth = ctypes.c_int32()
    rc = lib.voc_parse(
        path.encode(), n, ctypes.byref(k), ctypes.byref(depth),
        parents.ctypes.data_as(ctypes.c_void_p),
        leaf.ctypes.data_as(ctypes.c_void_p),
        desc.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise ValueError(f"vocabulary parse failed (code {rc})")
    PARSES += 1
    return int(k.value), int(depth.value), parents, leaf, desc, weights


class NativeInvertedFile:
    """C++ inverted file (ref: KeyFrameDatabase.cc inverted index)."""

    def __init__(self, n_words: int):
        self._lib = _library()
        self._h = self._lib.invfile_create(n_words)
        self.n_words = n_words

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.invfile_destroy(self._h)
            self._h = None

    def add(self, kf: int, words: np.ndarray) -> None:
        w = np.ascontiguousarray(words, np.int32)
        self._lib.invfile_add(
            self._h, kf, w.ctypes.data_as(ctypes.c_void_p), len(w)
        )

    def erase(self, kf: int, words: np.ndarray) -> None:
        w = np.ascontiguousarray(words, np.int32)
        self._lib.invfile_erase(
            self._h, kf, w.ctypes.data_as(ctypes.c_void_p), len(w)
        )

    def shared_counts(
        self, words: np.ndarray, max_kf: int
    ) -> np.ndarray:
        w = np.ascontiguousarray(words, np.int32)
        counts = np.zeros(max_kf, np.int32)
        self._lib.invfile_shared_counts(
            self._h, w.ctypes.data_as(ctypes.c_void_p), len(w),
            counts.ctypes.data_as(ctypes.c_void_p), max_kf,
        )
        return counts
