"""Build the port's CUDA sources with nvcc on first use and load them with
ctypes.

Each library is compiled from sources in ``csrc/`` only, for sm_90a, into
``tpudra_torch/build/`` under a name keyed by a hash of its sources, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The sources expose plain
C functions (no PyTorch headers), which keeps a build to seconds.  A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers, shared memory and spills; the
    # report is kept beside the library (build_log).
    "-Xptxas=-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(name: str, sources: tuple[str, ...]) -> Path:
    """Where the library built from ``sources`` (names under csrc/) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(library: Path) -> Path:
    return library.with_suffix(".log")


def build(name: str, sources: tuple[str, ...]) -> Path:
    """Compile ``sources`` into the shared library ``name`` unless a build of
    the same sources is already there; returns its path."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name.
    fd, tmp = tempfile.mkstemp(prefix=f".{out.stem}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in sources)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name} (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        build_log(out).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(libs) -> list[Path]:
    """Build every ``(name, sources)`` of ``libs`` at once, one nvcc each;
    returns their paths in order."""
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        return list(pool.map(lambda lib: build(*lib), libs))


@functools.cache
def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load the library; cached for the process."""
    return ctypes.CDLL(str(build(name, sources)))
