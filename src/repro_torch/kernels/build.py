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
(``fmaf``, ``mma.sync``, ``wgmma``), so the flag only keeps their scalar
steps (scale, decay, the bf16 split's remainders) rounded as written.
``-Xptxas -v`` leaves each kernel's registers, stack and spills in
`BUILD_LOG`; ``-D`` macros (`defines`) build a source's variants, such
as the day scan's probe modes.  `launch` calls a loaded entry point on
the current stream, and `pad_cols` widens a tensor to a built width.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}     # label -> nvcc wall seconds
BUILD_LOG: dict[str, str] = {}           # label -> nvcc's stderr (ptxas -v)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    for cand in (Path(os.environ.get("CUDA_HOME", "/nonexistent"))
                 / "bin" / "nvcc", shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _flags(defines) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _label(name: str, defines=()) -> str:
    return "+".join((name, *defines))


def library_path(name: str, defines=()) -> Path:
    """Where `csrc/<name>.cu` builds to with the macros `defines`, keyed
    by source + flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()) \
        .hexdigest()
    return BUILD_DIR / f"{_label(name, defines)}-{digest[:16]}.so"


def build(name: str, defines=()) -> Path:
    """Compile `csrc/<name>.cu` (with ``-D`` for each of `defines`) unless
    its hashed library exists; returns the library path and records the
    nvcc time in `BUILD_SECONDS`."""
    defines = tuple(defines)
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_SECONDS[_label(name, defines)] = time.perf_counter() - t0
    BUILD_LOG[_label(name, defines)] = proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)                # atomic: no half-written library
    return out


def build_all(jobs) -> dict:
    """Compile several sources at once, one nvcc for each, all started
    together.  A job is a source name or a (name, defines) pair; returns
    {job: library path}."""
    jobs = [(j, ()) if isinstance(j, str) else (j[0], tuple(j[1]))
            for j in jobs]
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        paths = pool.map(lambda j: build(*j), jobs)
        return {_label(*j): p for j, p in zip(jobs, paths)}


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu` with the macros `defines`,
    built on first use."""
    key = _label(name, tuple(defines))
    lib = _LOADED.get(key)
    if lib is None:
        lib = _LOADED[key] = ctypes.CDLL(str(build(name, defines)))
    return lib


def launch(fn, tensors, args, what: str) -> None:
    """`fn(pointers of tensors (None for None), *args, stream)` on the
    current stream of the tensors' device; raises if it returns a CUDA
    error."""
    dev = tensors[0].device
    # the inputs and the scratch may be freed when this returns while the
    # kernels still run: the caching allocator hands their memory only to
    # later work on the same stream
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[None if t is None else t.data_ptr() for t in tensors],
                 *args, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def pad_cols(t, width: int):
    """t with its last axis zero-padded to `width` (t itself at width)."""
    if t.shape[-1] == width:
        return t
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))
