"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source (``kernels/<name>/csrc/*.cu``) exposes a plain C
interface and is compiled by ``nvcc`` into its own shared library, loaded
with ``ctypes``.  The build happens at first use, from the checkout's own
sources, into ``build/kernels/`` at the repository root (listed in
``.gitignore``); a library's file name carries a hash of its source and the
compiler flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

#: repository root (src/repro_torch/kernels/launch.py -> four levels up)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: the SMs of the H100 SXM the kernels are built for (sm_90a): a grid
#: under this many blocks leaves SMs idle.  The wrappers' split plans
#: read it, so a plan is a function of the shape alone.
SMS = 132


class LaunchCounter:
    """Launches of one kernel (or calls of one plain version): a wrapper
    adds one where it launches, so a run can show which path it took."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return path


def library_path(source: Path) -> Path:
    """Where ``source``'s shared library lives once built."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[Path]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all started together; raise with the compiler's output if any
    build fails."""
    todo = [Path(s) for s in sources if not library_path(s).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        # build under a private name, then rename: a concurrent build of
        # the same source never sees a half-written library
        tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(src))
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))


def split_scratch(buffers: dict, device, stream: int, words: int,
                  n_tickets: int) -> tuple:
    """The (float32 partials, int32 tickets) a kernel that splits its work
    over blocks uses on ``stream`` of ``device``, kept in ``buffers`` (the
    kernel's own dict) and grown to at least ``words`` and ``n_tickets``
    as calls need.  The tickets start at zero and every launch leaves them
    zero (a split group's last block resets its own); launches on one
    stream run one after another, so they can share both."""
    import torch
    key = (device, stream)
    bufs = buffers.get(key)
    if bufs is None or bufs[0].numel() < words \
            or bufs[1].numel() < n_tickets:
        bufs = buffers[key] = (
            torch.empty(max(words, 256), dtype=torch.float32, device=device),
            torch.zeros(max(n_tickets, 256), dtype=torch.int32,
                        device=device))
    return bufs


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The loaded shared library for ``source``, built first if needed."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))
