"""Fuzz seeds 28-55 (rng seeds 939-966) of tests/test_fuzz_matrix.py
through ``TorchDecoder(device="cpu")`` against the inline decoder, as
tests/test_torch_fuzz_lo.py checks seeds 0-27."""
import pytest

from hevc_tpu import native
from test_torch_fuzz_lo import check_fuzz_seed
from torch_fuzz import N_CONFIGS

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


@pytest.mark.parametrize("seed", range(N_CONFIGS // 2, N_CONFIGS))
def test_fuzz_config_matches_inline(seed):
    check_fuzz_seed(seed)
