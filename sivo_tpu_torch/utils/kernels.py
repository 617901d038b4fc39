"""Build and load the port's CUDA kernels.

The sources in ``sivo_tpu_torch/csrc/*.cu`` have a plain C interface.
On first use each is compiled by its own ``nvcc`` process for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library under ``build/sivo_tpu_torch/`` at the root of the
checkout, named by a hash of the sources so an edited source is rebuilt,
and loaded with ``ctypes``. Every pointer and the stream go through
``ctypes.c_void_p``; each C entry point returns ``cudaGetLastError()``
after its launch.

Nothing here runs at import time: the CPU tests import every module,
and ``nvcc`` is needed only when a kernel is first launched on a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sivo_tpu_torch"
SOURCES = ("orb_describe.cu", "hamming_top2.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # raw, blur, level, xy, tables, angle, desc, n, H, W, border, stream
    "sivo_orb_describe": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # a, b, row_attr, col_attr, best_d, second_d, best_j, second_j,
    # n, m, use_ur, stream
    "sivo_hamming_top2": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise FileNotFoundError("nvcc not found (set CUDA_HOME)")


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsivo_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the kernels if the library for the current sources is
    missing: one nvcc per source, in parallel, then one link. Returns
    (library path, build seconds, ptxas report)."""
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        return path, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(o),
             str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(SOURCES, objs)
    ]
    outputs = [p.communicate()[0] for p in procs]
    report = "".join(outputs)
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run(
            [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(o) for o in objs)],
            capture_output=True, text=True)
        report += link.stdout + link.stderr
        if link.returncode != 0:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{report}")
    seconds = time.perf_counter() - t0
    log_path.write_text(report)
    os.replace(tmp, path)
    return path, seconds, report


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
