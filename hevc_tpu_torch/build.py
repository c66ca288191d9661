"""Build, load and call into the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` for ``sm_90a``, one process per source,
all started together, and link into one shared library with a plain C
interface, loaded with ctypes.  The library is built at first use and
rebuilt when a source is newer; it lands in ``build/`` next to this file,
which ``.gitignore`` lists.

The wrappers (``mc_cuda``, ``intra_cuda``, ``filters_cuda``,
``resid_cuda``, ``cabac_cuda``, ``probes``) share what is kept here: the
tensor check, the error check and the launch counts.  Each launch of a
kernel adds one to ``launches[name]``; nothing else touches the counts.
``launches["tma_encode"]`` counts the tensor maps ``probes.tensor_map``
encoded, which is host work and no launch.
"""
from __future__ import annotations

import ctypes as C
import glob
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_OUT = os.path.join(_DIR, "build")
_SO = os.path.join(_OUT, "libhevc_tpu_torch.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

launches = dict.fromkeys(("mc", "resid_add", "intra", "deblock", "sao",
                          "resid_tx", "cabac", "tile_shift", "tma_window",
                          "tma_pipe", "tma_encode"), 0)

_lock = threading.Lock()
_lib = None
# the current stream's handle as an int, and the current device's index,
# without building a Python object (None in a build of torch without CUDA,
# where no launch happens)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_get_device = getattr(torch._C, "_cuda_getDevice", None)


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("hevc_tpu_torch: nvcc not found (set CUDA_HOME)")


def sources() -> list:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu")))


def _run(cmd) -> str:
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}"
                           f"\n{r.stderr}")
    return r.stderr


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; return its
    path.  Raises with nvcc's stderr if a compile or the link fails."""
    srcs = sources()
    deps = srcs + glob.glob(os.path.join(_CSRC, "*.cuh"))
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
            os.path.getmtime(p) for p in deps):
        return _SO
    os.makedirs(_OUT, exist_ok=True)
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    with tempfile.TemporaryDirectory(dir=_OUT) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        with ThreadPoolExecutor(len(srcs)) as ex:
            logs = list(ex.map(_run, ([nvcc, *flags, "-c", "-o", o, s]
                                      for s, o in zip(srcs, objs))))
        lib = os.path.join(tmp, "lib.so")
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs])
        os.replace(lib, _SO)
    if verbose:
        print("".join(logs), end="")
    return _SO


def load() -> C.CDLL:
    """The kernel library, built and bound on first call (the lock is taken
    only until then: a launch pays for no lock)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = C.CDLL(build())
            p, i = C.c_void_p, C.c_int
            # the parameter structs go by pointer (ctypes.byref)
            lib.hevc_mc_launch.argtypes = [p, p, p, p, p, p]
            lib.hevc_mc_launch.restype = i
            lib.hevc_resid_add_launch.argtypes = [p, p, p]
            lib.hevc_resid_add_launch.restype = i
            # the launcher's host table of live records a chunk and class,
            # and the count of its launches, by address
            lib.hevc_intra_launch.argtypes = [p, p, p, i, p, p]
            lib.hevc_intra_launch.restype = i
            # the loop filters' FilterParams by address, and the stream
            lib.hevc_deblock_launch.argtypes = [p, p]
            lib.hevc_deblock_launch.restype = i
            lib.hevc_sao_launch.argtypes = [p, p]
            lib.hevc_sao_launch.restype = i
            # the residual stage's ResidParams by address, and the stream
            lib.hevc_resid_tx_launch.argtypes = [p, p]
            lib.hevc_resid_tx_launch.restype = i
            lib.hevc_launch_floor.argtypes = [p, i, C.c_longlong, p]
            lib.hevc_launch_floor.restype = i
            lib.hevc_cabac_launch.argtypes = [p, i, p, i, i, p, i, p, i, p,
                                              p]
            lib.hevc_cabac_launch.restype = i
            ip = C.POINTER(C.c_int)
            lib.hevc_cabac_resident_rows.argtypes = [ip]
            lib.hevc_cabac_resident_rows.restype = i
            lib.hevc_chain_latency_launch.argtypes = [i, i, i, p, p]
            lib.hevc_chain_latency_launch.restype = i
            # the launch's parameters (probes.ShiftParams, WindowParams)
            # by their address
            lib.hevc_tile_shift_launch.argtypes = [p, p, p, p, p]
            lib.hevc_tile_shift_launch.restype = i
            # a tensor map is 128 bytes of the caller's (a ctypes array)
            lib.hevc_tma_encode.argtypes = [p, p, i, i, i, i, ip]
            lib.hevc_tma_encode.restype = i
            lib.hevc_tma_window_launch.argtypes = [p, p, i, p, p]
            lib.hevc_tma_window_launch.restype = i
            lib.hevc_tma_pipe_launch.argtypes = [p, p, p, i, i, i, p]
            lib.hevc_tma_pipe_launch.restype = i
            lib.hevc_stream_sync.argtypes = [p]
            lib.hevc_stream_sync.restype = i
            lib.hevc_cuda_error_string.argtypes = [i]
            lib.hevc_cuda_error_string.restype = C.c_char_p
            _lib = lib
        return _lib


def stream(dev) -> int:
    """The handle of ``dev``'s current CUDA stream, without building a
    ``torch.cuda.Stream``."""
    return _raw_stream(dev.index)


def launch(dev, fn, *args) -> int:
    """``fn(*args)`` with ``dev`` the current CUDA device: a launcher's
    call, with no device guard (two device switches) when ``dev`` already
    is the current device."""
    if dev.index == _get_device():
        return fn(*args)
    with torch.cuda.device(dev):
        return fn(*args)


def check_tensor(name, t, dim, device) -> None:
    """Raise unless ``t`` is a contiguous int32 ``dim``-D tensor on
    ``device``: what a kernel's raw pointer assumes."""
    if (t.device != device or t.dtype != torch.int32 or t.dim() != dim
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous int32 {dim}-D tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def error_string(rc: int) -> str:
    return load().hevc_cuda_error_string(rc).decode()


def raise_on(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc} ({error_string(rc)})")
