"""Builds the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout (``.gitignore`` lists ``build/``), then loaded with ``ctypes``.
The hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register, shared-memory and spill counts) per library
# built in this process; empty for a library that was already built.
build_logs: dict[str, str] = {}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which size the persistent and
    grid-stride launches (the bag forward's units, the grouped-matmul
    backward's blocks)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, else from ``CUDA_HOME`` (or PyTorch's guess)."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    from torch.utils.cpp_extension import CUDA_HOME

    homes.append(CUDA_HOME)
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, named by a hash of
    the source, the headers beside it and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiling it if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    out = lib_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        build_logs[name] = proc.stdout + proc.stderr
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def load_all(names) -> None:
    """Builds and loads several libraries at once: one ``nvcc`` per source,
    all started together."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load, names))
