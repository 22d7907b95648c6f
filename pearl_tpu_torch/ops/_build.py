"""Build the port's CUDA kernels with `nvcc` at first use and load them.

Each `csrc/<name>.cu` is compiled on its own into a shared library with a
plain C interface (`-gencode arch=compute_90a,code=sm_90a`) under
`build/pearl_tpu_torch/` at the repo root, and loaded with `ctypes`. The file
name carries a hash of the sources and flags, so an edited source is rebuilt.
Only the sources in the checkout are built; a missing `nvcc` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pearl_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: named by a hash of the sources
    (the .cu and every header in csrc) and the flags."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its current build exists; returns the
    library's path. Writes through a temporary file so a cut build leaves
    nothing that looks finished."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    (BUILD_DIR / f"{so.stem}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build several kernels at once, one `nvcc` per source."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def on_card(name: str, tensor) -> bool:
    """How the wrapper `name` dispatches on `tensor`: True for a CUDA tensor
    (launch the kernel), False for a CPU tensor (run the plain version);
    any other device raises."""
    if tensor.is_cuda:
        return True
    if tensor.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {tensor.device}")
    return False


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`'s library, once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib
