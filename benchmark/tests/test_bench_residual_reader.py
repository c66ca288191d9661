"""The reader of the residual kernel's launches: None where the program
counts none (a program without the kernel, or off CUDA), the launches a
picture on a made-up window, and its entry in the manifest."""
import pytest

from benchmark import bank

NAME = "residual_launches_per_picture"
READ = bank.metric_readers([NAME])[NAME]


def _ctx(spans, pictures=4):
    return {"spans": spans, "pictures": pictures, "busy_s": None,
            "window_s": None, "least_s": None}


@pytest.mark.parametrize("spans,pictures", [
    ({}, 4), ({"loop_filter_launches": {"calls": 4, "total": 12}}, 4),
    ({"residual_launches": {"calls": 8, "total": 8}}, 0)])
def test_nothing_to_read_reads_none(spans, pictures):
    assert READ(_ctx(spans, pictures)) is None


@pytest.mark.parametrize("total,want", [(4, 1.0), (8, 2.0), (7, 1.75)])
def test_a_made_up_window_reads_its_launches_a_picture(total, want):
    spans = {"residual_launches": {"calls": total, "total": total}}
    assert READ(_ctx(spans)) == pytest.approx(want)


def test_the_metric_is_in_the_manifest_for_every_cell():
    m = {x["name"]: x for x in bank.manifest()["per_layer"]}[NAME]
    assert m["moves"] == "decode_fps" and "workloads" not in m
    assert m["layer"] == "frame-program enqueue (pipeline.frame_program)"
    assert m["source"] == "program_counter" and m["better"] == "lower"
    assert m["unit"] == "launches/picture"
