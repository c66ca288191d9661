"""The reader of the host pack's level-map cells: None where the program
counts none (a program without the counter), the cells an access unit on
a made-up window, and its entry in the manifest."""
import pytest

from benchmark import bank

NAME = "pack_map_cells_per_picture"
READ = bank.metric_readers([NAME])[NAME]


def _ctx(spans, pictures=4):
    return {"spans": spans, "pictures": pictures, "busy_s": None,
            "window_s": None, "least_s": None}


@pytest.mark.parametrize("spans,pictures", [
    ({}, 4), ({"residual_launches": {"calls": 4, "total": 4}}, 4),
    ({"pack_map_cells": {"calls": 8, "total": 8}}, 0)])
def test_nothing_to_read_reads_none(spans, pictures):
    assert READ(_ctx(spans, pictures)) is None


@pytest.mark.parametrize("total,want", [
    (0, 0.0), (4 * 388_800, 388_800.0), (388_800, 97_200.0)])
def test_a_made_up_window_reads_its_cells_a_picture(total, want):
    spans = {"pack_map_cells": {"calls": 4, "total": total}}
    assert READ(_ctx(spans)) == pytest.approx(want)


def test_the_metric_is_in_the_manifest_for_every_cell():
    m = {x["name"]: x for x in bank.manifest()["per_layer"]}[NAME]
    assert m["moves"] == "decode_fps" and "workloads" not in m
    assert m["layer"] == "host pack (pack.py)"
    assert m["source"] == "program_counter" and m["better"] == "lower"
    assert m["unit"] == "cells/picture"


def test_a_traced_run_reads_the_cells(tiny_cell):
    """A traced run of ``main1080.ra`` at 128x64 on the CPU: its IDR and
    the P and B pictures' intra CUs give cells, at most three h4 x w4 maps
    a picture."""
    from benchmark import run
    r = run.run_cell(tiny_cell, 2 ** 31 + 21, 2.0, True, device="cpu")
    assert r["correct"]
    v = r["metrics"][NAME]
    assert v["unit"] == "cells/picture"
    assert 0 < v["value"] <= 3 * (128 // 4) * (64 // 4)
