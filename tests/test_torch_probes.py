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


# ---------------------------------------------------------------------------
# the launch geometry of the kernels (csrc/probes.cu), mirrored in Python
# ---------------------------------------------------------------------------

TILE_SHAPES = [(48, 256), (1, 4), (7, 13), (1088, 1920)]


def _shifts(h, w):
    """Negative, zero, equal to the tile's size and past it."""
    return [(3, 37), (-5, -300), (0, 0), (h, w), (2 * h + 1, 3 * w + 2),
            (-h - 1, w + 1)]


def _gather(tile, src, oh, ow):
    """The output each thread of tile_shift_kernel writes, from the source
    indices of tile_shift_sources."""
    out = np.full(oh * ow, -1, np.int64)
    e0 = 4 * np.arange(src.shape[0])
    for j in range(4):
        live = src[:, j] >= 0
        out[e0[live] + j] = tile.ravel()[src[live, j]]
    return out.reshape(oh, ow)


@pytest.mark.parametrize("h,w", TILE_SHAPES)
def test_tile_shift_threads_gather_np_roll(h, w):
    tile = np.arange(h * w, dtype=np.int64).reshape(h, w) * 7 - 3
    blocks, threads = probes.tile_shift_grid(h, w)
    assert (blocks - 1) * threads * 4 < h * w <= blocks * threads * 4
    for sy, sx in _shifts(h, w):
        src = probes.tile_shift_sources(h, w, (sy, sx), probes.ROLL, h, w)
        assert src.shape == (blocks * threads, 4)
        assert (src >= 0).sum() == h * w      # each element once
        assert np.array_equal(_gather(tile, src, h, w),
                              np.roll(tile, (sy, sx), (0, 1))), (sy, sx)


@pytest.mark.parametrize("h,w", TILE_SHAPES)
def test_tile_shift_threads_gather_dynamic_slice(h, w):
    tile = np.arange(h * w, dtype=np.int32).reshape(h, w)
    oh, ow = min(probes.SLICE_SHAPE[0], h), min(probes.SLICE_SHAPE[1], w)
    for sy, sx in _shifts(h, w):
        src = probes.tile_shift_sources(h, w, (sy, sx), probes.SLICE, oh, ow)
        want = np.asarray(jax.lax.dynamic_slice(tile, (sy, sx), (oh, ow)))
        assert np.array_equal(_gather(tile, src, oh, ow), want), (sy, sx)


def test_tile_shift_grid_of_the_probe_tile():
    """One thread a 16-byte segment of the output: the (48, 256) roll is 24
    CTAs of 128 threads, the (40, 128) slice 10."""
    assert probes.tile_shift_grid(*probes.TILE) == (24, 128)
    assert probes.tile_shift_grid(*probes.SLICE_SHAPE) == (10, 128)
    assert probes.tile_shift_grid(7, 13) == (1, 128)


def test_a_tile_over_227_kb_is_accepted():
    """The kernel stages nothing, so a tile of any size up to 2^31
    elements passes the checks; the CPU path equals np.roll."""
    h, w = 1088, 1920
    assert h * w * 4 > 227 * 1024
    x = np.arange(h * w, dtype=np.int32).reshape(h, w)
    s = _shift(-517, 1001)
    p = probes.tile_shift_plan(h, w, probes.ROLL)
    assert (p.h, p.w, p.mode, p.oh, p.ow, p.blocks) == (
        h, w, probes.ROLL, h, w, probes.tile_shift_grid(h, w)[0])
    got = probes.tile_shift(torch.from_numpy(x), s, probes.ROLL)
    assert np.array_equal(got.numpy(), np.roll(x, (-517, 1001), (0, 1)))
    for mode in (probes.SLICE, 2):   # a window larger than the tile
        with pytest.raises(ValueError, match="tile|mode"):
            probes.tile_shift(torch.zeros((1, 4), dtype=torch.int32), s,
                              mode)
    with pytest.raises(ValueError, match="tile"):   # 2^31 elements
        probes.tile_shift_plan(1 << 16, 1 << 15, probes.ROLL)


def _seeded_windows(seed, n=60):
    H, W = probes.PLANE
    rng = np.random.default_rng(seed)
    out = [((256, 256), (0, 3)), ((8, 256), (5, W - 257)),
           ((256, 252), (H - 256, W - 253)), ((1, 4), (0, 0))]
    for _ in range(n):
        wh, ww = int(rng.integers(1, 257)), 4 * int(rng.integers(1, 65))
        out.append(((wh, ww), (int(rng.integers(0, H - wh + 1)),
                               int(rng.integers(0, W - ww + 1)))))
    return out


def _window_gather(plane, p):
    """The window read through plan ``p`` as the kernel reads it: each
    CTA's boxes staged, then its rows taken ``lead`` columns in."""
    out = np.full((p.wh, p.ww), -1, plane.dtype)
    for y, xs, ys, r0, r1 in probes.window_boxes(p):
        staged = [plane[y:y + p.bh, x:x + p.bw] for x in xs]
        for r in range(r0, r1):
            for s in range(p.ww // 4):
                if len(staged) == 2 and s:   # box 1 from column 4 on
                    seg = staged[1][r - ys, 4 * s - 4 + p.lead:][:4]
                else:
                    seg = staged[0][r - ys, 4 * s + p.lead:][:4]
                out[r, 4 * s:4 * s + 4] = seg
    return out


def _check_plan(shape, origin):
    """The plan of the window: each box inside the plane at an x that is a
    multiple of 4 int32, each window row read out by one CTA, and the
    gather through the boxes equal to window_plain."""
    (wh, ww), (oy, ox) = shape, origin
    H, W = PLANE.shape
    p = probes.window_plan(shape, origin)
    assert (p.wh, p.ww, p.oy, p.ox) == (wh, ww, oy, ox)
    assert p.lead == ox % 4 and p.bh == min(wh, probes.WINDOW_BAND)
    assert p.bw <= probes.MAX_BOX and p.bw % 4 == 0
    assert p.bw == (ww + 4 if p.lead and ww + 4 <= 256 else ww)
    rows = np.zeros(wh, int)
    for y, xs, ys, r0, r1 in probes.window_boxes(p):
        assert oy <= y and y + p.bh <= oy + wh and y == oy + ys
        assert ys <= r0 < r1 <= ys + p.bh
        rows[r0:r1] += 1
        for x in xs:
            assert x % 4 == 0 and 0 <= x and x + p.bw <= W
        assert xs[0] <= ox and ox + ww <= xs[-1] + p.bw
    assert (rows == 1).all()
    got = _window_gather(PLANE, p)
    assert np.array_equal(got, PLANE[oy:oy + wh, ox:ox + ww])
    assert np.array_equal(got, probes.window_plain(
        torch.from_numpy(PLANE), shape, origin, False).numpy())


@pytest.mark.parametrize("case", probes.WINDOW_CASES, ids=lambda c: c.name)
def test_window_plan_of_each_probe_case(case):
    if case.shape[1] * 4 % 16:
        # the encoder refuses the window's box before any plan is launched
        assert case.name == "rows8, lanes39"
        return
    _check_plan(case.shape, case.origin)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_plan_of_seeded_windows(seed):
    for shape, origin in _seeded_windows(seed):
        _check_plan(shape, origin)


def test_window_plan_of_the_odd_read_and_one_box():
    """The (40, 128) read at x = 37: ten bands of one (4, 132) box from
    x = 36; without the split, one CTA and the window's own box at x = 37
    (the box that faults)."""
    p = probes.window_plan((40, 128), (13, 37))
    assert (p.lead, p.box, p.boxes, p.bands) == (1, (4, 132), 1, 10)
    assert {b[1] for b in probes.window_boxes(p)} == {(36,)}
    q = probes.window_plan((40, 128), (13, 37), split=False)
    assert (q.lead, q.box, q.bands) == (0, (40, 128), 1)
    assert probes.window_boxes(q) == [(13, (37,), 0, 0, 40)]
    wide = probes.window_plan((8, 256), (5, 1151))
    assert (wide.box, wide.boxes) == ((4, 256), 2)
    assert probes.window_boxes(wide)[0][1] == (1148, 1152)


def test_mirrored_kernel_constants():
    import os
    import re
    path = os.path.join(os.path.dirname(probes.__file__), "csrc",
                        "probes.cu")
    src = open(path).read()
    assert int(re.search(r"constexpr int kShiftThreads = (\d+);",
                         src).group(1)) == probes.SHIFT_THREADS
    for struct in (probes.ShiftParams, probes.WindowParams):
        fields = re.search(r"struct %s \{\s*int ([^;]+);" % struct.__name__,
                           src).group(1)
        assert [f.strip() for f in fields.split(",")] == \
            [f for f, _ in struct._fields_]


def test_pipe_tiling_covers_the_big_plane_once():
    org = probes.pipe_tiling(probes.PIPE_BIG_PLANE).numpy()
    bh, bw = probes.PIPE_BOX
    assert org.shape == (170 * 32, 2)
    seen = np.zeros(probes.PIPE_BIG_PLANE, np.int8)
    for y, x in org[::97]:
        seen[y:y + bh, x:x + bw] += 1
    assert seen.max() == 1
    assert (org[:, 1] % 4 == 0).all() and org[:, 0].max() + bh <= 8192
    assert probes.pipe_bytes(org) == 534_773_760
