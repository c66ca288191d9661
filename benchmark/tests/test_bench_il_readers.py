"""The readers of the SHVC inter-layer spans: the spans summed per access
unit handed in, None where the window recorded none of them (one layer,
or a program without the span)."""
import pytest

from benchmark import bank

NEW = ("il_build_ms", "il_motion_ms")
READ = bank.metric_readers(list(NEW))


def _ctx(spans, pictures=4):
    return {"spans": spans, "pictures": pictures, "busy_s": None,
            "window_s": None, "least_s": None}


SPANS = {
    "il_color_map": {"calls": 4, "total_s": 0.004},
    "il_upsample": {"calls": 4, "total_s": 0.02},
    "il_pad": {"calls": 4, "total_s": 0.008},
    "il_motion": {"calls": 4, "total_s": 0.06},
    "pack_worker": {"calls": 12, "total_s": 0.9},
}


def test_the_build_sums_its_three_spans_per_access_unit():
    assert READ["il_build_ms"](_ctx(SPANS)) == pytest.approx(8.0)
    no_cgs = {k: v for k, v in SPANS.items() if k != "il_color_map"}
    assert READ["il_build_ms"](_ctx(no_cgs)) == pytest.approx(7.0)


def test_the_motion_mapping_per_access_unit():
    assert READ["il_motion_ms"](_ctx(SPANS)) == pytest.approx(15.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(name):
    assert READ[name](_ctx({})) is None
    assert READ[name](_ctx({"pack_worker": SPANS["pack_worker"]})) is None


@pytest.mark.parametrize("name", NEW)
def test_no_access_unit_handed_in_reads_none(name):
    assert READ[name](_ctx(SPANS, pictures=0)) is None


def test_both_are_in_the_manifest_for_the_shvc_cell_alone():
    per_layer = {m["name"]: m for m in bank.manifest()["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == ["shvc1080.ldp"]
        assert per_layer[name]["moves"] == "decode_fps"
