"""Card probe, kernel build and the shared launch plumbing of the wrappers.

The hand-written CUDA kernels live in ``csrc/*.cu``.  :func:`library` builds
them at first use with ``nvcc`` for ``sm_90a`` (one compile per source, all
started together, then one link) into a single shared library with a plain C
interface, caches it under ``kernels/_build/`` keyed by a hash of the sources
and flags, and loads it with ``ctypes``.

There is no switch that routes a CUDA tensor to the plain PyTorch versions:
a wrapper given a CUDA tensor launches its kernel or raises.

A wrapper given only ``meta`` tensors (a dry run, ``launch/dryrun.py``)
takes its *meta route*: it allocates exactly what its kernel returns, on
``meta``, and reports the kernel's operation count to the callbacks of
:func:`meta_kernel_calls` (:func:`meta_launch`), since no FLOP counter sees
a ctypes launch.  It launches nothing and counts no launch.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def cuda_available() -> bool:
    """A CUDA card of compute capability 9.0 (Hopper) or newer is present."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability(0) >= (9, 0)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` where no Hopper card is
    present raises: nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not cuda_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA card of compute "
                "capability >= 9.0 is available; pass device='cpu' to run the "
                "plain PyTorch versions"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_tag(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libreprotorch_<hash>.so`` (reused
    when the sources and flags are unchanged).  The ptxas report of each
    source goes to ``_build/<hash>.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    tag = _source_tag(sorted(CSRC.glob("*.cu*")))
    so = BUILD_DIR / f"libreprotorch_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        objs = [work / f"{src.stem}.o" for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs, failed = [], []
        for src, p in zip(sources, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        (BUILD_DIR / f"{tag}.log").write_text("\n".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def build_log() -> str:
    """The ptxas report (registers, shared memory, spills) of the last build."""
    logs = sorted(BUILD_DIR.glob("*.log"), key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    S3 = ctypes.POINTER(ctypes.c_longlong)
    lib.rmsnorm_fwd.argtypes = [P, P, P, LL, I, F, I, I, I, I, I, I, I, P]
    lib.rmsnorm_bwd.argtypes = [P, P, P, P, P, P, LL, I, F, I, I, I, I, I, I, I, P]
    lib.flash_attention_fwd.argtypes = [
        P, P, P, P, P, I, I, I, I, I, I, I, S3, S3, S3, S3, I, I, I, F, I, P,
    ]
    lib.flash_attention_bwd.argtypes = [P] * 10 + [I] * 7 + [S3] * 8 + [I, I, I, F, I, P]
    lib.decode_attention_fwd.argtypes = [
        P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, S3, S3, S3, S3, F, I, P,
    ]
    lib.decode_attention_chunk.argtypes = []
    lib.decode_attention_padded_dim.argtypes = [I, I]
    lib.ssd_intra_chunk_fwd.argtypes = [P] * 7 + [I] * 7 + [S3] * 7 + [I, P]
    lib.ssd_intra_chunk_bwd_tc.argtypes = [P] * 16 + [I] * 7 + [S3] * 12 + [P]
    # flash's kernels above a head dim of 256 (``flash_attention_split.cu``)
    # and the wide routes (``*_wide.cu``) take their main routes' arguments
    # (the ssd backward's without the main route's scratch)
    lib.flash_attention_split_fwd.argtypes = lib.flash_attention_fwd.argtypes
    lib.flash_attention_split_bwd.argtypes = lib.flash_attention_bwd.argtypes
    lib.flash_attention_split_smem.argtypes = [I, I, I]
    lib.flash_attention_wide_fwd.argtypes = lib.flash_attention_fwd.argtypes
    lib.flash_attention_wide_bwd.argtypes = lib.flash_attention_bwd.argtypes
    lib.decode_attention_wide_fwd.argtypes = lib.decode_attention_fwd.argtypes
    lib.ssd_intra_chunk_wide_fwd.argtypes = lib.ssd_intra_chunk_fwd.argtypes
    lib.ssd_intra_chunk_wide_bwd.argtypes = [P] * 12 + [I] * 7 + [S3] * 12 + [I, P]
    lib.kernels_error_string.argtypes = [I]
    lib.kernels_error_string.restype = ctypes.c_char_p
    for fn in (lib.rmsnorm_fwd, lib.rmsnorm_bwd, lib.flash_attention_fwd,
               lib.flash_attention_bwd, lib.decode_attention_fwd, lib.decode_attention_chunk,
               lib.decode_attention_padded_dim,
               lib.ssd_intra_chunk_fwd, lib.ssd_intra_chunk_bwd_tc, lib.flash_attention_split_fwd,
               lib.flash_attention_split_bwd, lib.flash_attention_split_smem,
               lib.flash_attention_wide_fwd, lib.flash_attention_wide_bwd, lib.decode_attention_wide_fwd,
               lib.ssd_intra_chunk_wide_fwd, lib.ssd_intra_chunk_wide_bwd):
        fn.restype = I
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  Raises when the build
    or the load fails; callers never fall back."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                _lib = _declare(ctypes.CDLL(str(build())))
    return _lib


def strides(t: torch.Tensor, dims) -> ctypes.Array:
    """The element strides of ``t`` along ``dims`` as a C ``long long[]``."""
    return (ctypes.c_longlong * len(dims))(*(t.stride(d) for d in dims))


def check_cuda_tensors(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor lies on the same CUDA card of compute capability >= 9.0."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {dev}")
    if torch.cuda.get_device_capability(dev) < (9, 0):
        raise RuntimeError(f"{name}: the kernel is built for sm_90a; {dev} is older")


def dtype_code(name: str, t: torch.Tensor) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)") from None


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_handle(t: torch.Tensor) -> int:
    """The calling thread's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = library().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} (cudaError {rc})")


class LaunchCounter:
    """Launches of one kernel wrapper, counted where the kernel is launched
    and nowhere else, in all (``count``) and by the launch's problem shape
    (``by_shape``, keyed by the tuple the wrapper names).  Wrappers run on
    the serve engine's worker threads, so the increment takes a lock."""

    def __init__(self) -> None:
        self.count = 0
        self.by_shape: dict = {}
        self._lock = threading.Lock()

    def add(self, shape: tuple) -> None:
        with self._lock:
            self.count += 1
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.by_shape = {}


# ---------------------------------------------------------------------------
# The meta route (a dry run: launch/dryrun.py)
# ---------------------------------------------------------------------------

_meta_callbacks: list = []


def check_kernel_tensors(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on ``meta`` (the meta route, module
    docstring); else every tensor must lie on one Hopper card
    (:func:`check_cuda_tensors`), and False."""
    if all(t.device.type == "meta" for t in tensors):
        return True
    check_cuda_tensors(name, *tensors)
    return False


@contextlib.contextmanager
def meta_kernel_calls(callback):
    """Within the block, every meta route calls ``callback(name, shape,
    flops, info)``: the kernel's name, the problem shape its counter would
    key, the operations it does on that input and a dict of what else
    describes the call (the mask of an attention)."""
    _meta_callbacks.append(callback)
    try:
        yield
    finally:
        _meta_callbacks.remove(callback)


def meta_launch(name: str, shape: tuple, flops: int, **info) -> None:
    """Report one meta-route call of kernel ``name`` (see
    :func:`meta_kernel_calls`)."""
    for cb in list(_meta_callbacks):
        cb(name, shape, flops, info)
