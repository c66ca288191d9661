"""The plain versions of the probe kernels (hevc_tpu_torch/probes.py)
against what the TPU probe scripts expect, bit for bit: np.roll and the
slice of tools/probe_roll.py, the window reads and writes of
tools/probe_dma.py, and the block copy of probe_roll.py's pipeline; and the
key of the tensor-map cache, which no CPU tensor reaches."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hevc_tpu_torch import probes  # noqa: E402

TILE = np.arange(48 * 256, dtype=np.int32).reshape(48, 256)
PLANE = np.arange(512 * 1408, dtype=np.int32).reshape(512, 1408)


def _shift(sy, sx):
    return torch.tensor([sy, sx], dtype=torch.int32)


@pytest.mark.parametrize("sy,sx", [(3, 37), (-5, 300), (0, 0), (47, -1)])
def test_roll_plain_equals_np_roll(sy, sx):
    want = np.roll(np.roll(TILE, sy, 0), sx, 1)
    for fn in (probes.tile_shift_plain, probes.tile_shift):
        got = fn(torch.from_numpy(TILE), _shift(sy, sx), probes.ROLL)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("sy,sx", [(3, 37), (20, 200), (-4, 0)])
def test_slice_plain_equals_dynamic_slice(sy, sx):
    want = np.asarray(jax.lax.dynamic_slice(TILE, (sy, sx), (40, 128)))
    if (sy, sx) == (3, 37):  # the probe's own expectation
        assert np.array_equal(want, TILE[3:43, 37:165])
    for fn in (probes.tile_shift_plain, probes.tile_shift):
        got = fn(torch.from_numpy(TILE), _shift(sy, sx), probes.SLICE)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", probes.WINDOW_CASES, ids=lambda c: c.name)
def test_window_plain_equals_probe_dma(case):
    (wh, ww), (oy, ox) = case.shape, case.origin
    plane = torch.from_numpy(PLANE.copy())
    got = probes.tma_window(plane, case.shape, case.origin, case.write)
    if case.write:
        want = PLANE.copy()
        want[oy:oy + wh, ox:ox + ww] = 7
        assert got is plane  # in place, as the TMA store
    else:
        want = PLANE[oy:oy + wh, ox:ox + ww]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,origin", [((8, 16), (508, 1400)),
                                          ((8, 4), (13, -3)),
                                          ((8, 300), (0, 0))])
def test_window_outside_the_plane_is_refused(shape, origin):
    with pytest.raises(ValueError, match="inside"):
        probes.tma_window(torch.from_numpy(PLANE), shape, origin, False)


def test_tensor_map_key_differs_by_pointer():
    a = torch.zeros((64, 128), dtype=torch.int32)
    b = torch.zeros((64, 128), dtype=torch.int32)
    assert probes.tensor_map_key(a, (8, 128)) == \
        probes.tensor_map_key(a.view(64, 128), (8, 128))
    assert probes.tensor_map_key(a, (8, 128)) != \
        probes.tensor_map_key(b, (8, 128))
    # a plane that starts inside another one is another plane
    assert probes.tensor_map_key(a, (8, 128)) != \
        probes.tensor_map_key(a[1:], (8, 128))


def test_tensor_map_key_differs_by_plane_shape():
    a = torch.zeros((64, 128), dtype=torch.int32)
    assert a.view(128, 64).data_ptr() == a.data_ptr()
    assert probes.tensor_map_key(a, (8, 64)) != \
        probes.tensor_map_key(a.view(128, 64), (8, 64))
    assert probes.tensor_map_key(a, (8, 64)) != \
        probes.tensor_map_key(a[:32], (8, 64))


@pytest.mark.parametrize("box", [(8, 64), (16, 128), (128, 8)])
def test_tensor_map_key_differs_by_box(box):
    a = torch.zeros((64, 128), dtype=torch.int32)
    assert probes.tensor_map_key(a, (8, 128)) != probes.tensor_map_key(a, box)
    assert probes.tensor_map_key(a, box) == probes.tensor_map_key(a, box)


def test_cpu_tensor_never_reaches_the_tensor_map_cache():
    from hevc_tpu_torch import build
    before = (dict(probes._TENSOR_MAPS), build.launches["tma_encode"],
              build.launches["tma_window"], build.launches["tma_pipe"])
    plane = torch.from_numpy(PLANE.copy())
    for case in probes.WINDOW_CASES:
        probes.tma_window(plane, case.shape, case.origin, case.write)
    probes.tma_pipe(torch.zeros((1024, 1536), dtype=torch.int32),
                    probes.pipe_origins()[:4])
    with pytest.raises(ValueError, match="lies on cpu"):
        probes.tensor_map(plane, (8, 128))
    assert (dict(probes._TENSOR_MAPS), build.launches["tma_encode"],
            build.launches["tma_window"], build.launches["tma_pipe"]) == before


def test_pipe_origins_follow_probe_roll():
    org = probes.pipe_origins().numpy()
    rng = np.random.RandomState(0)
    by = (rng.randint(0, 900, 2880) & ~7).astype(np.int32)
    bx = (rng.randint(0, 1200, 2880) & ~127).astype(np.int32)
    assert org.shape == (2880, 2) and org.dtype == np.int32
    assert np.array_equal(org, np.stack([by, bx], 1))
    assert (org[:, 0] + 48 <= 1024).all() and (org[:, 1] + 256 <= 1536).all()


def test_pipe_plain_equals_block_copy():
    x = np.arange(1024 * 1536, dtype=np.int32).reshape(1024, 1536)
    org = probes.pipe_origins()[:96]
    want = np.zeros_like(x)
    for oy, ox in org.tolist():
        want[oy:oy + 48, ox:ox + 256] = x[oy:oy + 48, ox:ox + 256]
    got = probes.tma_pipe(torch.from_numpy(x), org)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("origin", [(-8, 0), (980, 0), (0, 1290), (8, 130)])
def test_pipe_box_outside_or_unaligned_is_refused(origin):
    x = torch.zeros((1024, 1536), dtype=torch.int32)
    org = torch.tensor([[0, 0], origin], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        probes.tma_pipe(x, org)


def test_probe_cli_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probes.main(["--device", "cpu"]) == 2
    assert probes.main(["--device", "cpu", "--one-box", "1"]) == 2


@pytest.mark.parametrize("t,dim", [
    (torch.zeros((4, 8), dtype=torch.int64), 2),
    (torch.zeros((4, 8), dtype=torch.int32), 1),
    (torch.zeros((8, 4), dtype=torch.int32).t(), 2)])
def test_kernel_arguments_are_checked(t, dim):
    from hevc_tpu_torch import build
    build.check_tensor("ok", torch.zeros((4, 8), dtype=torch.int32), 2,
                       torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous int32"):
        build.check_tensor("t", t, dim, torch.device("cpu"))
