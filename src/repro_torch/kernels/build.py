"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file exposes a plain C function (no PyTorch headers),
so ``nvcc`` compiles each in seconds. At first use :func:`library` starts
one ``nvcc -c`` per source, all at once, links the objects into one
shared library under ``src/repro_torch/_build/`` (listed in
``.gitignore``) and loads it with ``ctypes``. The library's file name
carries a hash of the sources and flags, so an edited source rebuilds and
a finished build is reused by later processes.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3``, and deliberately no
``--use_fast_math``: the level-1, cisweep and sgrid decisions compare atanhf
against τ, and the default ``-prec-div``/``-prec-sqrt`` and no-FTZ
settings keep them as close to the reference as the card allows.

``LAUNCHES`` counts, per kernel, the launches the wrappers made (corr's
split-K path is two: the splits and their reduction); a run
resets it with :func:`reset_launches` and reads it afterwards to show
which kernels its path went through.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
#: C signature of every exported launcher: (argtypes); each returns the
#: launch's cudaError_t as an int.
SIGNATURES = {
    "repro_corr_xtx": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "repro_level1_dense": (_P, _P, _P, _P, _I, _F, _P),
    "repro_cholinv": (_P, _P, _P, _P, _P, _LL, _I, _F, _P),
    "repro_cisweep": (_P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _F, _P),
    "repro_level0": (_P, _P, _I, _F, _P),
    "repro_gsq": (_P, _P, _LL, _I, _I, _I, _P),
    "repro_sgrid": (_P, _P, _P, _P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P),
}

#: kernel name → launches made through its wrapper (see module docstring)
LAUNCHES: dict[str, int] = {"corr": 0, "level0": 0, "level1": 0, "cholinv": 0, "cisweep": 0,
                            "gsq": 0, "sgrid": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # 0.0 when an earlier build was reused
    ptxas: str  # what ``-Xptxas -v`` reported per source


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                       "are built on a machine with the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources, out: Path) -> str:
    """Compile every source in parallel, link one shared library at
    ``out``; returns the compilers' diagnostics (ptxas register reports)."""
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout + link.stderr)
        os.replace(tmp_lib, out)
    return "\n".join(logs)


@functools.lru_cache(maxsize=1)
def library() -> Built:
    """Build (once per source hash) and load the kernels' shared library."""
    sources = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librepro_torch_{_digest(sources)}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.exists():
        t0 = time.monotonic()
        log_path.write_text(_compile(_nvcc(), sources, out))
        seconds = time.monotonic() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    ptxas = log_path.read_text() if log_path.exists() else ""
    return Built(lib=lib, path=out, seconds=seconds, ptxas=ptxas)


# PyTorch's current stream of a device as a raw cudaStream_t: the call its
# own generated code makes, a few µs cheaper than building a Stream object
# (which matters at the µs sizes of NCI-60's kernels); CPU-only builds lack it
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(device: torch.device) -> int:
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def launch(kernel: str, symbol: str, device: torch.device, *args, kernels: int = 1) -> None:
    """Call one exported launcher on PyTorch's current stream of
    ``device``, raise on a refused launch, and count the ``kernels``
    launches it made under ``kernel``."""
    stream = _current_stream(device)
    rc = getattr(library().lib, symbol)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with cudaError_t {rc}")
    LAUNCHES[kernel] += kernels


def require_cuda(*tensors) -> None:
    """Kernel wrappers take CUDA tensors on one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"kernel launch needs CUDA tensors, got {dev}")
