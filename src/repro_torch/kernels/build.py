"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under `csrc/` has a plain C entry point.  On first use it is
compiled for Hopper (`sm_90a`) into ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source and the flags, and loaded
with `ctypes`; later calls in the process reuse the loaded library, and
later processes reuse the file.  Nothing here runs when a module is
imported, so the package imports on machines without nvcc or a card.

Flags: no ``--use_fast_math`` and ``-fmad=false`` for every source.  The
day scan needs both for bit equality with its plain version (a one-ulp
change near a trip threshold flips a throttle level).  The flash and SSD
kernels are held to tolerances and spell out their multiply-adds
(``fmaf``, ``mma.sync``), so the flag only keeps their scalar steps
(scale, decay, the bf16 split's remainders) rounded as written.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}     # name -> nvcc wall seconds


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/nonexistent"))
                 / "bin" / "nvcc", shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by source + flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its hashed library exists; returns
    the library path and records the nvcc time in `BUILD_SECONDS`."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)                # atomic: no half-written library
    return out


def build_all(names) -> dict:
    """Compile several sources at once, one nvcc for each, all started
    together; returns {name: library path}."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
