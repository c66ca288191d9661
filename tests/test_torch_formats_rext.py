"""The CASES of tests/test_dependent_slices.py and tests/test_rext_tools.py
through ``TorchDecoder(device="cpu")`` against
``Decoder(recon_backend="jax")``, bit-exact on every plane, with every SEI
MD5 correct.  Dependent-segment pictures have no native records: their
Python plan becomes the record stream (``native.plan_to_records``), and
every picture runs the frame program."""
import pytest

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from torch_gate import native_ready
from torch_streams import FORMATS, assert_same, decode_port, planes_of

pytestmark = pytest.mark.skipif(not native_ready(native),
                                reason="native toolchain unavailable")


@pytest.mark.parametrize("name", [k for k in FORMATS
                                  if k.startswith(("dep_", "rext_"))])
def test_torch_decoder_matches_jax(name):
    data = FORMATS[name]()
    want = planes_of(Decoder(check_md5=True, recon_backend="jax")
                     .decode_bytes(data))
    got, n_prog = decode_port(data, "cpu")
    assert_same(want, got, name)
    assert n_prog == len(got)
