"""``hevc_tpu_torch/csrc/resid.cu`` built by the host's C++ compiler:
without ``__CUDACC__`` the file exports ``hevc_residuals_host``, which runs
the kernel's per-lane steps over host memory, warp by warp.  The CPU tests
hold that code against the plain version and the JAX package's through
the stand-in of ``host_residuals``."""
import ctypes as C
import os
import shutil
import subprocess

import pytest

from hevc_tpu_torch import build, resid_cuda

SRC = os.path.join(os.path.dirname(build.__file__), "csrc", "resid.cu")


def build_host_lib(out_dir):
    """resid.cu compiled into ``out_dir`` and loaded; skips the test
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = os.path.join(str(out_dir), "libresid_host.so")
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x",
                    "c++", SRC, "-o", so], check=True, capture_output=True)
    lib = C.CDLL(so)
    lib.hevc_residuals_host.argtypes = [C.c_void_p]
    lib.hevc_residuals_host.restype = C.c_int
    return lib


def host_residuals(lib):
    """A stand-in of ``resid_cuda.residuals`` that runs the kernel's code
    on host memory through the wrapper's parameters: per class int16
    levels, int32 rows and banks on the CPU; returns the four pools."""
    def residuals(levels, rmeta, bd, bank, _tables=None):
        p, pools = resid_cuda.resid_params(levels, rmeta, bd, bank)
        assert lib.hevc_residuals_host(C.byref(p)) == 0
        return pools

    return residuals


BANK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "data")


def bank_residual_inputs(bank, n_aus):
    """The residual-stage inputs of each picture of the first ``n_aus``
    access units of ``benchmark/data/<bank>``'s first segment, decoded on
    the CPU (``capture.captured_residuals``) with every other stage of the
    frame program stubbed out: stage A and the pack run as they do, and
    no sample is reconstructed (stage A reads none), so a 1080p picture
    takes about a second."""
    import torch

    from hevc_tpu_torch import mc_cuda, pipeline
    from hevc_tpu_torch.capture import bank_prefix, captured_residuals

    def pools(levels, rmeta, bd, bank, tables):
        return tuple(torch.zeros((m.shape[0] + 1, 4 << c, 4 << c),
                                 dtype=torch.int32)
                     for c, m in enumerate(rmeta))

    def first(x, *_a, **_k):
        return x

    stubs = {(pipeline, "residuals"): pools, (mc_cuda, "mc"): first,
             (mc_cuda, "resid_add"): first,
             (pipeline, "reconstruct_wavefront"): first,
             (pipeline, "deblock_planes"): first,
             (pipeline, "sao_planes"): first}
    orig = {k: getattr(*k) for k in stubs}
    for (mod, name), fn in stubs.items():
        setattr(mod, name, fn)
    try:
        return captured_residuals(
            bank_prefix(os.path.join(BANK, bank), n_aus),
            torch.device("cpu"))
    finally:
        for (mod, name), fn in orig.items():
            setattr(mod, name, fn)
