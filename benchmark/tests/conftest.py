"""Fixtures of the benchmark's own tests: a bank of tiny segments encoded
by ``make_bank`` (CPU, seconds), and the card check of card-only tests.

Whether there is a card is decided inside the ``card`` fixture, never at
import."""
import os

import pytest

from benchmark import bank, make_bank, run


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


TINY = {"width": 128, "height": 64}


@pytest.fixture(scope="session")
def tiny_cell(tmp_path_factory):
    """``main1080.ra`` at 128x64: 2 segments of 6 pictures, on the CPU."""
    out = str(tmp_path_factory.mktemp("bank"))
    cfg = bank.config("main1080")
    cfg["encoder"].update(TINY)
    mix = dict(bank.traffic("ra"), segments=2, pictures=6)
    make_bank.make("main1080", "ra", "test", 2, cfg=cfg, mix=mix, out=out)
    return run.Cell(name="main1080.ra", layers=1,
                    segments=bank.load_bank("main1080", "ra", out),
                    mix=mix, end_to_end=["decode_fps",
                                         "picture_latency_p95_ms",
                                         "setup_s"],
                    per_layer=[m["name"] for m in bank.manifest()["per_layer"]
                               if "main1080.ra" in m.get("workloads",
                                                         ["main1080.ra"])],
                    out_bytes=TINY["width"] * TINY["height"] * 3 // 2)


@pytest.fixture(autouse=True)
def _build_in_tmp(tmp_path, monkeypatch):
    """Reference digests and traces of the tests go to a directory of
    their own."""
    monkeypatch.setattr(bank, "BUILD", str(tmp_path / "build"))
    os.makedirs(bank.BUILD, exist_ok=True)
