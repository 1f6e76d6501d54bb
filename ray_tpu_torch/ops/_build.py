"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds.  Libraries land
in ``build/ray_tpu_torch_kernels/`` at the repository root (git-ignored),
named by a hash of the source, every ``csrc/*.cuh`` header a source may
include, and the flags, so an edited source or header rebuilds and an
unchanged one is reused.  Nothing is built at import: the first
launch builds what it needs, and ``build()`` builds every kernel at once,
one ``nvcc`` per source, all started together.

Every launch goes through ``launch``, which counts it in ``launches``
under its C symbol (one per kernel launch, nowhere else), so a run can
show that its main path went through the kernels; ``check_operand``
rejects a tensor a kernel does not take before its pointer is passed.
This module imports torch only inside the functions that need it:
workers on nodes without a card import none.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "ray_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C symbol -> launches since the last reset_launches().
launches: "collections.Counter[str]" = collections.Counter()

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str, tuple], ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built from source at first use")


def _target(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: every ``csrc/*.cu``) that have
    no library for their current source yet, one ``nvcc`` process per
    source, all in parallel.  Raises on a non-zero ``nvcc`` exit.  Returns
    name -> library path; ptxas' register/spill report for each build is
    kept beside its library as ``<lib>.log``."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for name in names:
        lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        lib.with_suffix(".so.log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """C launcher ``symbol`` of kernel ``name``, returning an int error
    code.  Pointers (and the stream) must be ``c_void_p`` in ``argtypes``:
    ctypes would pass a bare Python int as a 32-bit int and cut it.  The
    configured function is cached per ``(name, symbol, argtypes)``, each
    its own function object, so no caller changes another's signature."""
    key = (name, symbol, tuple(argtypes))
    fn = _fns.get(key)
    if fn is None:
        fn = library(name)[symbol]  # a new object; getattr would share one
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[key] = fn
    return fn


def check_launch(name: str, err: int) -> None:
    """Raise if the C launcher reported a non-zero ``cudaGetLastError()``."""
    if err:
        msg = library(name).rtt_error_string
        msg.restype, msg.argtypes = ctypes.c_char_p, [ctypes.c_int]
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({msg(err).decode()})")


def launch(name: str, symbol: str, argtypes, dev, *args,
           stream: Optional[int] = None) -> None:
    """Launch C symbol ``symbol`` of kernel ``name`` (see ``function``)
    with ``args`` and, last, ``stream`` (default: ``dev``'s current
    stream), with ``dev`` the current device; count it in
    ``launches[symbol]`` and raise if it failed."""
    import torch

    fn = function(name, symbol, argtypes)
    if stream is None:
        stream = current_stream(dev)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    launches[symbol] += 1
    check_launch(name, err)


def check_operand(name: str, what: str, t, dev, dtype, shape=None, *,
                  aligned: bool = False) -> int:
    """Check operand ``what`` of kernel ``name`` before its pointer is
    passed: on ``dev``, of ``dtype``, of ``shape`` when given, contiguous
    and, if ``aligned`` (the kernel reads it in 16-byte vectors), starting
    on 16 bytes.  Raises TypeError for the dtype and ValueError for the
    rest; returns ``t.data_ptr()``."""
    if t.device != dev:
        raise ValueError(f"{name}: {what} must be on {dev}, is on "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, is {t.dtype}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: {what} must be of shape {tuple(shape)}, "
                         f"is {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} of shape {tuple(t.shape)} is not "
                         f"contiguous")
    ptr = t.data_ptr()
    if aligned and ptr % 16:
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary")
    return ptr


def current_stream(dev) -> int:
    """The handle of CUDA device ``dev``'s current stream: the value of
    ``torch.cuda.current_stream(dev).cuda_stream``, read without building
    a ``torch.cuda.Stream`` (microseconds of host time a launch, which
    the serving path pays once a decode step)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
