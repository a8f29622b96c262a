"""Build the port's CUDA sources into shared libraries, load them, and
check what a wrapper hands to a kernel.

Each ``csrc/*.cu`` file has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout and loaded with ``ctypes``; the library name carries a hash
of the source, so an edited source rebuilds and an unchanged one loads the
existing library.  ``-Xptxas -v`` output (registers, shared memory, spills)
is kept on the returned handle.  A failed build raises; nothing falls back.
:func:`load_all` builds several sources at once, one ``nvcc`` each;
:data:`SOURCES` lists them all.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

#: root of the checkout (src/repro_torch/kernels/build.py -> ../../..)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


#: every kernel source of the port, as ``package/stem`` of its
#: ``kernels/<package>/csrc/<stem>.cu``
SOURCES = ("decode_attn/paged_decode_attn", "decode_attn/decode_attn",
           "bdi/bdi_packed_decode", "bdi/bdi_uniform", "fpc/fpc_decode",
           "fused_matmul/matmul_q8", "fused_matmul/matmul_bdi",
           "cpack/cpack_decode")


@dataclasses.dataclass
class Built:
    """A loaded kernel library and what the compiler said about it."""
    name: str
    path: Path
    lib: ctypes.CDLL
    ptxas_log: str


_LOCK = threading.Lock()
_LOADED: dict[str, Built] = {}
_NAME_LOCKS: dict[str, threading.Lock] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    homes = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels can only be built where the toolkit is")
    return found


def source_path(name: str) -> Path:
    """csrc file of a kernel library, e.g. 'decode_attn/paged_decode_attn'."""
    pkg, stem = name.split("/")
    return Path(__file__).resolve().parent / pkg / "csrc" / f"{stem}.cu"


def compile_library(name: str) -> tuple[Path, str]:
    """Compile one source (if its hashed library is missing) and return
    (library path, ptxas log).  Safe to run in parallel processes: the
    library is written under a temporary name and renamed into place."""
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    stem = f"{src.stem}-{digest.hexdigest()[:12]}"
    lib = BUILD_DIR / f"{stem}.so"
    log = BUILD_DIR / f"{stem}.ptxas.txt"
    if lib.is_file() and log.is_file():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [find_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {res.returncode}):"
                           f"\n{res.stdout}\n{res.stderr}")
    log.write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)
    return lib, log.read_text()


def load(name: str) -> Built:
    """The loaded library of kernel source ``name`` (built at first use)."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        got = _LOADED.get(name)
        if got is None:
            path, log = compile_library(name)
            got = _LOADED[name] = Built(name, path, ctypes.CDLL(str(path)),
                                        log)
        return got


def load_all(names) -> list[Built]:
    """Build and load several sources in parallel (one nvcc each)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        return list(ex.map(load, names))


# -- what every kernel wrapper does around a launch ---------------------------

def function(name: str, fn_name: str, argtypes):
    """C entry point ``fn_name`` of source ``name``, its argument types
    declared (each pointer and the stream ``c_void_p``) and returning the
    CUDA error code as an int."""
    fn = getattr(load(name).lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def check_tensor(t, name, device, dtype, shape):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    require(t.device == device, f"{name} is on {t.device}, not {device}")
    require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, the one a kernel runs on."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


_COUNTERS: dict = {}


def tile_counters(name: str, device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` arrival counters that the
    kernels of ``name`` share on ``device``.

    A kernel that splits a reduction across blocks counts, per output
    tile, the blocks that have written their partial; the last one merges
    the partials and sets the count back to 0, so the buffer is zero again
    after every launch and is allocated (and zeroed) only when it grows.
    Launches that use it must run on one stream, one after another."""
    key = (name, torch.device(device))
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf
