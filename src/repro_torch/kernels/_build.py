"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``<repo>/build/repro_torch_kernels/lib<name>-<hash>.so``; all sources are
compiled at once, in parallel, on the first call that needs a kernel.
The hash covers every file under ``csrc/``, so an edited source builds
anew and an unchanged one is loaded as it is. Nothing is built or loaded
when the package is imported: the CPU tests import every module on a
machine with no ``nvcc``.

Build by hand (what :func:`build` runs, once per source)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/librms_norm-<hash>.so \\
         src/repro_torch/kernels/csrc/rms_norm.cu
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: resolved from the package path, never from the working directory
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: dtype codes of the C entries (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are compiled at first use")


def lib_path(name: str, digest: Optional[str] = None) -> Path:
    return BUILD_DIR / f"lib{name}-{digest or source_hash()}.so"


def build() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source name: compiler output}`` for the sources it compiled.
    Raises ``RuntimeError`` with the compiler's output if one fails.
    """
    digest = source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not lib_path(s.stem, digest).exists()]
    procs = []
    nvcc = _nvcc()
    for src in todo:
        out = lib_path(src.stem, digest)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src.stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode})\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)    # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build()
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` with its ctypes signature.

    Pointers and the stream are ``c_void_p``: left undeclared, ctypes
    would pass them as 32-bit ints and cut them.
    """
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its ``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t {err}")


def stream_and_device(t: torch.Tensor):
    """(device index, current stream handle) for a launch on ``t``'s card."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(dev: int) -> int:
    """The card's SM count (read once; no host sync): the launch plans size
    their grids by it."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


_COUNTERS: Dict[tuple, torch.Tensor] = {}
#: buffers a larger one replaced: a captured CUDA graph may still hold
#: their address, so they live as long as the process
_RETIRED: List[torch.Tensor] = []


def counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` int32 zeros on ``device``, one buffer per stream: the
    decode and NMS kernels count their finished CTAs there and leave it
    zeroed, so launches on one stream, which run one after another, share
    it and it is set to zero once.

    Under CUDA graph capture the stream's buffer must already exist, made
    by an eager launch on the capture stream (the engines' warm-up step):
    one made now would come from the graph's private pool, and its zeroing
    would be a node of that graph alone. Raises then instead.
    """
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"kernel counters: no buffer of {n} for this stream while it is "
                "captured; run the step once eagerly on the capture stream "
                "first")
        if buf is not None:
            _RETIRED.append(buf)
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf
