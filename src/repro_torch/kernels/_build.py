"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into
an object, all sources at once in parallel, and the objects are linked
into one shared library with a plain C interface that ``ctypes`` loads.
The build happens at the first CUDA use, never at import, and lands in
``build/repro_torch/`` under the checkout, keyed by a hash of the
sources and flags, so an unchanged tree reuses its library.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0.  A
machine with a card but no ``nvcc`` raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

# C entry points: name -> argtypes (pointers and the stream as c_void_p)
SIGNATURES = {
    # row_ptr, other, weight, hub_rows, v, v_self, out, alpha, beta, n,
    # k, hub_slots, hub_threshold, stream (K1 and K2)
    "edge_spmm_rows_launch": [P, P, P, P, P, P, P, F, F, I, I, I, I, P],
    # v, av, partial, out, n, k, num_parts, rows_per_part, tile_rows, stream
    "gram2k_launch": [P, P, P, P, I, I, I, I, I, P],
    # v, av, m1, m2, colscale, out, n, k, stream
    "panel_mix_launch": [P, P, P, P, P, P, I, I, P],
    # l, u, out, c, n, k, stream
    "poly_step_launch": [P, P, P, F, I, I, P],
    # l, u, out, n, k, stream
    "dense_matvec_panel_launch": [P, P, P, I, I, P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit on PATH")
    return path


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link one library; returns its
    path.  Reuses a library already built from the same sources."""
    sources = _sources()
    lib = BUILD_DIR / f"librepro_torch_{_source_hash(sources)}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode != 0]
        (BUILD_DIR / "ptxas.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"--- {s.name}\n{log}" for s, log in failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
                 device: torch.device) -> None:
    """Raise unless ``t`` has the device, dtype and shape a kernel takes and
    is contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream() -> int:
    """PyTorch's current CUDA stream, as the handle the C entries take."""
    return torch.cuda.current_stream().cuda_stream
