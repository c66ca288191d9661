"""The residual kernel's code against the JAX package's residual stage, on
the same inputs, bit for bit (tolerance 0).

``csrc/resid.cu`` built by the host's C++ compiler (tests/resid_host.py)
runs the kernel's per-lane code through the wrapper's parameters:
(a) on every case of ``hevc_tpu_torch.resid_cases`` (every class, DCT and
    DST-VII, skip and bypass, flat and matrix scaling, both signs of the
    dequantisation's shift, levels at the int16 limits, 8 to 16 bit,
    rotation, RDPCM, CCP, empty classes) against
    ``hevc_tpu.tpu.recon._residuals``;
(b) on the residual inputs of pictures of the benchmark's banks (an IDR, a
    P and a leaf B of ``main1080/ra``, an IDR of ``main1080/intra``, the
    base layer's IDR and an enhancement-layer P of ``shvc1080_x1.5/ldp``)
    against ``_residuals`` and the port's plain ``recon.residuals``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.tpu.recon import _residuals
from hevc_tpu_torch import resid_cases, resid_cuda
from hevc_tpu_torch.capture import pick_picture
from hevc_tpu_torch.tables import tables_from_reference
from resid_host import bank_residual_inputs, build_host_lib, host_residuals

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernel's code on host memory, as ``resid_cuda.residuals``."""
    return host_residuals(build_host_lib(tmp_path_factory.mktemp("resid")))


def _jax(levels, rmeta, bd, bank):
    """``_residuals`` on the arrays of tensors (levels as int32)."""
    def j(ts, dt=np.int32):
        return [jnp.asarray(np.asarray(t, dt)) for t in ts]

    out = _residuals(j(levels), j(rmeta), bd, j(bank))
    return [np.asarray(o) for o in out]


def _same(got, want, what):
    assert len(got) == len(want) == 4, what
    for c, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g)
        assert g.shape == w.shape, (what, c, g.shape, w.shape)
        assert np.array_equal(g, w), \
            f"{what} class {c}: {int((g != w).sum())} samples differ"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(resid_cases.CASES))
def test_kernel_code_matches_the_jax_package_on_cases(host, name, seed):
    case = resid_cases.make(name, seed)
    levels, rmeta, bd, bank, tables = resid_cases.tensors(case, CPU)
    _same(host(levels, rmeta, bd, bank, tables),
          _jax(case["levels"], case["rmeta"], bd, case["bank"]), name)


BANKS = resid_cases.BANK_PICTURES
PICTURES = [(b, k, lay) for b, (_n, picks) in sorted(BANKS.items())
            for k, lay in picks]


@pytest.fixture(scope="module")
def bank_calls():
    """Each bank's captured residual inputs, decoded once."""
    return {b: bank_residual_inputs(b, n) for b, (n, _p) in BANKS.items()}


@pytest.mark.parametrize("bank,kind,layer", PICTURES)
def test_kernel_code_matches_the_jax_package_on_bank_pictures(
        host, bank_calls, bank, kind, layer):
    call = pick_picture([c for c in bank_calls[bank] if c["at"][0] == layer],
                        kind)
    levels, rmeta, bd, scale = call["args"]
    what = f"{bank} {kind} {call['at']}"
    assert levels[0].dtype == torch.int16
    got = host(levels, rmeta, bd, scale)
    _same(got, _jax(levels, rmeta, bd, scale), what)
    plain = resid_cuda.residuals_plain(levels, rmeta, bd, scale,
                                       tables_from_reference(CPU))
    _same(got, [p.numpy() for p in plain], what)
    # a 2160p, 1080p or 720p picture's records, all four classes at work
    assert sum(m.shape[0] for m in rmeta) > 1000, what
