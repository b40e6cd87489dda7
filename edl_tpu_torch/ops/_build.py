"""Build the port's CUDA sources into one shared library and load it.

Each ``csrc/*.cu`` file (which include the ``csrc/*.cuh`` and ``*.h``
headers) is compiled for ``sm_90a`` (Hopper) by its own ``nvcc`` process,
all of them at once, and the objects are linked into one shared library
with a plain C interface, which `load` opens with ``ctypes``. Nothing here
includes PyTorch's headers, so a build takes seconds, not minutes.

The library lands in ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a digest of every file under ``csrc/`` and the
flags: an edited source or header builds anew, an unchanged one is reused.
The build happens at first use, never at import, so the CPU tests import
every module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, into the log
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources() -> List[Path]:
    """The translation units that nvcc compiles."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library built from the current sources lives: named by a
    digest of the flags and of every file under ``csrc/``, headers included,
    so that an edited ``.cuh`` builds anew."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(str(src.relative_to(CSRC)).encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libedl_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc on PATH")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _run(cmds: List[List[str]]) -> List[str]:
    """Run the commands at once, one process each; their output, in order,
    each after a line ``nvcc: <last argument> in <seconds> s``. Raises
    ``RuntimeError`` with a failed command's output."""

    def one(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        done = list(pool.map(one, cmds))
    for cmd, (proc, _) in zip(cmds, done):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cmd[-1]}:\n{proc.stdout}")
    return [f"nvcc: {Path(cmd[-1]).name} in {seconds:.1f} s\n{proc.stdout}"
            for cmd, (proc, seconds) in zip(cmds, done)]


def build() -> Path:
    """Compile and link the library unless it is already built; return its
    path. The compilers' output (with ``-Xptxas=-v``) is kept beside the
    library as ``<name>.log``. Raises ``RuntimeError`` with the compiler's
    output when a source does not compile."""
    out = library_path()
    if out.exists():
        return out
    objs = out.parent / f"{out.stem}.{os.getpid()}.objs"
    objs.mkdir(parents=True, exist_ok=True)
    sources = _sources()
    nvcc = _nvcc()
    logs = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"), str(src)]
                 for src in sources])
    tmp = out.parent / f"{out.stem}.{os.getpid()}.so"
    logs += _run([[nvcc, *NVCC_FLAGS, "-shared", *(str(objs / f"{src.stem}.o") for src in sources),
                   "-o", str(tmp)]])
    out.with_suffix(".log").write_text("".join(logs))
    shutil.rmtree(objs)
    os.replace(tmp, out)  # atomic: a concurrent process sees all or nothing
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
