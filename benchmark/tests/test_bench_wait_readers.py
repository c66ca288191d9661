"""The readers of the program's waits, uploads and allocations: None on an
empty span window (the program before its tracing had them), the right
value on a made-up one."""
import pytest

from benchmark import bank

NEW = ("pack_queue_ms", "pack_worker_busy_share", "output_wait_ms",
       "api_self_ms", "h2d_bytes_per_picture", "device_allocs_per_picture")
READ = bank.metric_readers(list(NEW))


def _ctx(spans, pictures=4):
    return {"spans": spans, "pictures": pictures, "busy_s": None,
            "window_s": None, "least_s": None}


SPANS = {
    "api_decode": {"calls": 5, "total_s": 0.5, "self_s": 0.38},
    "stage_a_native": {"calls": 4, "total_s": 0.1},
    "stage_a_python": {"calls": 1, "total_s": 0.02},
    "pack_queue": {"calls": 8, "total_s": 0.04},
    "pack_worker": {"calls": 8, "total_s": 0.9},
    "output_wait": {"calls": 3, "total_s": 0.12},
    "h2d_bytes": {"calls": 20, "total": 4_000_000},
    "device_allocs": {"calls": 8, "total": 6},
    "_wall": {"total_s": 1.2},
}
WANT = {"pack_queue_ms": 10.0, "pack_worker_busy_share": 75.0,
        "output_wait_ms": 30.0, "api_self_ms": 95.0,
        "h2d_bytes_per_picture": 1_000_000.0,
        "device_allocs_per_picture": 1.5}


@pytest.mark.parametrize("name", NEW)
def test_nothing_recorded_reads_none(name):
    assert READ[name](_ctx({})) is None
    assert READ[name](_ctx({"stage_a_native": {"calls": 1,
                                               "total_s": 0.1}})) is None


@pytest.mark.parametrize("name", NEW)
def test_a_made_up_window_reads_its_value(name):
    assert READ[name](_ctx(SPANS)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_no_picture_handed_in_reads_none(name):
    got = READ[name](_ctx(SPANS, pictures=0))
    assert got is None or name == "pack_worker_busy_share"


def test_every_new_metric_is_in_the_manifest_for_both_cells():
    per_layer = {m["name"]: m for m in bank.manifest()["per_layer"]}
    for name in NEW:
        assert name in per_layer and "workloads" not in per_layer[name]
