"""The SHVC cell ``shvc1080.ldp`` at 192x96 over 128x64 on the CPU (the
program's plain versions): a sound run is correct, a traced run reads the
inter-layer metrics, and the control is not correct."""
import pytest

from benchmark import bank, make_bank, run
from benchmark.control import ControlProgram

CELL = "shvc1080.ldp"
SIZES = ({"width": 128, "height": 64}, {"width": 192, "height": 96})


@pytest.fixture(scope="module")
def tiny_shvc(tmp_path_factory):
    """2 segments of 4 access units, encoded by ``make_bank`` (its
    reference digests kept apart from the checkout's)."""
    out = str(tmp_path_factory.mktemp("bank"))
    w = bank.workload(CELL)
    cfg = bank.config(w["config"])
    for layer, size in zip(cfg["encoder"]["layers"], SIZES):
        layer.update(size)
    mix = dict(bank.traffic(w["traffic"]), segments=2, pictures=4)
    build, bank.BUILD = bank.BUILD, str(tmp_path_factory.mktemp("build"))
    try:
        make_bank.make(w["config"], w["traffic"], "test", 2, cfg=cfg,
                       mix=mix, out=out)
    finally:
        bank.BUILD = build
    return run.Cell(name=CELL, layers=2,
                    segments=bank.load_bank(w["config"], w["traffic"], out),
                    mix=mix, end_to_end=["decode_fps",
                                         "picture_latency_p95_ms",
                                         "setup_s"],
                    per_layer=[m["name"] for m in bank.manifest()["per_layer"]
                               if CELL in m.get("workloads", [CELL])],
                    out_bytes=SIZES[1]["width"] * SIZES[1]["height"] * 3 // 2)


def test_the_cell_is_two_layers_and_reports_the_il_metrics():
    cell = run.load_cell(CELL)
    assert cell.layers == 2 and cell.chips == 1
    assert {"il_build_ms", "il_motion_ms"} <= set(cell.per_layer)
    assert cell.out_bytes == 1920 * 1080 * 3 // 2
    assert "il_build_ms" not in run.load_cell("main1080.ra").per_layer


def test_a_sound_run_is_correct(tiny_shvc):
    r = run.run_cell(tiny_shvc, 2 ** 31 + 77, 2.0, False, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"decode_fps", "picture_latency_p95_ms",
                                 "setup_s"}


def test_a_traced_run_reads_the_inter_layer_metrics(tiny_shvc):
    r = run.run_cell(tiny_shvc, 2 ** 31 + 78, 2.0, True, device="cpu")
    assert r["correct"]
    assert r["metrics"]["il_build_ms"]["value"] > 0
    assert r["metrics"]["il_motion_ms"]["value"] > 0


def test_the_control_is_not_correct(tiny_shvc):
    r = run.run_cell(tiny_shvc, 5, 2.0, False, device="cpu",
                     make_program=ControlProgram)
    assert not r["correct"]
    assert r["checks"]["planes_wrong"]["value"] > 0
