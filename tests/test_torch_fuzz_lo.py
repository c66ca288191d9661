"""The configs of tests/test_fuzz_matrix.py through
``TorchDecoder(device="cpu")``, rng seeds 911-938 (fuzz seeds 0-27;
tests/test_torch_fuzz_hi.py takes 28-55): no config raises, every picture
runs the frame program, every plane equals the inline decoder's and every
SEI MD5 is correct.

The fuzz matrix compares only luma with the openHEVC oracle under SAO +
pcm_loop_filter_disabled, for a chroma quirk of that oracle; the inline
decoder implements the spec there, so every plane is compared here."""
import dataclasses

import numpy as np
import pytest

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from torch_fuzz import N_CONFIGS, fuzz_stream, sample_config
from torch_streams import assert_same, decode_port, planes_of

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def check_fuzz_seed(seed):
    cfg, data = fuzz_stream(seed)
    want = planes_of(Decoder(check_md5=True, recon_backend="inline")
                     .decode_bytes(data))
    got, n_prog = decode_port(data, "cpu")
    assert_same(want, got, f"fuzz seed {seed}: {cfg}")
    assert n_prog == len(got)


@pytest.mark.parametrize("seed", range(N_CONFIGS // 2))
def test_fuzz_config_matches_inline(seed):
    check_fuzz_seed(seed)


def test_sampler_copy_draws_the_fuzz_matrix_configs():
    from test_fuzz_matrix import _sample_config
    for seed in range(N_CONFIGS):
        a = _sample_config(np.random.default_rng(911 + seed))
        b = sample_config(np.random.default_rng(911 + seed))
        port = dataclasses.asdict(b)
        # the port's one field the JAX package lacks, at its default
        assert port.pop("source_bit_depth") == 0, seed
        assert dataclasses.asdict(a) == port, seed
