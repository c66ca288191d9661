"""``hevc_tpu_torch/csrc/filters.cu`` built by the host's C++ compiler:
without ``__CUDACC__`` the file exports ``hevc_deblock_host`` and
``hevc_sao_host``, which run the kernels' per-item code over host memory.
The CPU tests hold that code against the plain filters and the JAX
package's through the stand-ins of ``host_filters``."""
import ctypes as C
import os
import shutil
import subprocess

import pytest

from hevc_tpu_torch import build, filters_cuda

SRC = os.path.join(os.path.dirname(build.__file__), "csrc", "filters.cu")


def build_host_lib(out_dir):
    """filters.cu compiled into ``out_dir`` and loaded; skips the test
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    so = os.path.join(str(out_dir), "libfilters_host.so")
    subprocess.run([gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-x",
                    "c++", SRC, "-o", so], check=True, capture_output=True)
    lib = C.CDLL(so)
    for fn in (lib.hevc_deblock_host, lib.hevc_sao_host):
        fn.argtypes = [C.c_void_p]
        fn.restype = C.c_int
    return lib


def host_filters(lib):
    """Stand-ins of ``filters_cuda.deblock_planes`` / ``sao_planes`` that
    run the kernels' code on host memory, through the wrapper's
    parameters: deblocking in place, SAO into new planes."""
    def deblock(planes, qp4, bs_v, bs_h, beta, tc, qp_offs, _tables, bd,
                sub_w, sub_h, nf4):
        p = filters_cuda.deblock_params(planes, qp4, bs_v, bs_h, beta, tc,
                                        qp_offs, bd, sub_w, sub_h, nf4)
        assert lib.hevc_deblock_host(C.byref(p)) == 0
        return planes

    def sao(planes, *a):
        p, out = filters_cuda.sao_params(planes, *a)
        assert lib.hevc_sao_host(C.byref(p)) == 0
        return out

    return deblock, sao
