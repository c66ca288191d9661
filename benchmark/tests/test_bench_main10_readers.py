"""The readers of the fetch's bytes and the intra kernel's launches: None
where the program counts nothing, the counter a picture on a made-up
window, their entries in the manifest; and the cell ``main2160.ra``.
``tests/test_torch_main10_2160.py`` runs the cell on a small bank of its
configuration."""
import pytest

from benchmark import bank, make_bank, run

READERS = bank.metric_readers(["d2h_bytes_per_picture",
                               "intra_launches_per_picture"])
COUNTERS = {"d2h_bytes_per_picture": "d2h_bytes",
            "intra_launches_per_picture": "intra_launches"}


def _ctx(spans, pictures=4):
    return {"spans": spans, "pictures": pictures, "busy_s": None,
            "window_s": None, "least_s": None}


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("spans,pictures", [
    ({}, 4), ({"residual_launches": {"calls": 4, "total": 4}}, 4),
    ({"d2h_bytes": {"calls": 2, "total": 9},
      "intra_launches": {"calls": 2, "total": 9}}, 0),
    ({"d2h_bytes": {"calls": 1, "total_s": 0.5},
      "intra_launches": {"calls": 1, "total_s": 0.5}}, 4)])
def test_nothing_to_read_reads_none(name, spans, pictures):
    assert READERS[name](_ctx(spans, pictures)) is None


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("total,pictures,want", [
    (4 * 24_883_200, 4, 24_883_200.0), (3_110_400, 1, 3_110_400.0),
    (427 * 3, 4, 320.25)])
def test_a_made_up_window_reads_its_counter_a_picture(name, total, pictures,
                                                      want):
    spans = {COUNTERS[name]: {"calls": pictures, "total": total}}
    assert READERS[name](_ctx(spans, pictures)) == pytest.approx(want)


@pytest.mark.parametrize("name,unit,layer,moves", [
    ("d2h_bytes_per_picture", "bytes/picture", "fetch (pipeline.LazyPlanes)",
     "picture_latency_p95_ms"),
    ("intra_launches_per_picture", "launches/picture",
     "frame-program enqueue (pipeline.frame_program)", "decode_fps")])
def test_the_metric_is_in_the_manifest_for_every_cell(name, unit, layer,
                                                      moves):
    m = {x["name"]: x for x in bank.manifest()["per_layer"]}[name]
    assert (m["unit"], m["layer"], m["moves"]) == (unit, layer, moves)
    assert m["source"] == "program_counter" and m["better"] == "lower"
    assert "workloads" not in m
    for w in bank.manifest()["workloads"]:
        assert name in run.load_cell(w["name"]).per_layer


def test_the_cell_is_main_10_at_2160p_on_one_chip():
    cell = run.load_cell("main2160.ra")
    assert (cell.layers, cell.chips) == (1, 1)
    assert cell.out_bytes == 3840 * 2160 * 3 // 2 * 2 == 24_883_200
    assert len(cell.segments) == 4
    assert all(len(s.aus) == 32 for s in cell.segments)
    cfg = bank.config("main10_2160")
    assert cfg["reduced"] == ["content"]
    assert (cfg["encoder"]["bit_depth"], cfg["encoder"]["source_bit_depth"],
            cfg["encoder"]["chroma_format_idc"]) == (10, 8, 1)
    meta = bank.load_json(bank.bank_dir("main10_2160", "ra") + "/bank.json")
    for seg in meta["segments"]:
        assert seg["encoder"] == [make_bank.encoder_settings(
            cfg, bank.traffic("ra"), seg["encoder"][0]["seed"] - 1)[0]]
