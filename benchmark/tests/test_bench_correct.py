"""The comparison that decides ``correct``: a sound run of the tiny cell
on the CPU (the program's plain versions) is correct, and each fault the
cell can have, planted under the harness, makes it false; so does the
control (the reference with deblocking skipped)."""
import numpy as np
import pytest

from benchmark import check, run
from benchmark.control import ControlProgram
from benchmark.program import Program


class _Fault(Program):
    """The program, broken where its pictures are produced."""
    warm_up = False

    def __init__(self, layers, device):
        super().__init__(layers, device)
        self.n = 0
        self.last = None

    def _bend(self, pics):
        out = []
        for pts, planes, bd in pics:
            self.n += 1
            out += self.bend(self.n, pts, planes, bd)
            self.last = planes
        return out

    def decode(self, au, pts):
        return self._bend(super().decode(au, pts))

    def close(self):
        return self._bend(super().close())


class Stale(_Fault):
    """A step that returns its state unchanged: the last picture again."""
    def bend(self, n, pts, planes, bd):
        return [(pts, self.last if n == 4 else planes, bd)]


class HalfLeftOut(_Fault):
    """Half of the pictures left out."""
    def bend(self, n, pts, planes, bd):
        return [] if n % 2 else [(pts, planes, bd)]


class OneSample(_Fault):
    """One sample altered where it is produced."""
    def bend(self, n, pts, planes, bd):
        if n == 3:
            planes = [p.copy() for p in planes]
            planes[1][5, 7] ^= 1
        return [(pts, planes, bd)]


def _run(cell, program=None):
    return run.run_cell(cell, 11, 2.0, False, device="cpu",
                        make_program=program)


def test_a_sound_run_is_correct(tiny_cell):
    r = _run(tiny_cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"decode_fps", "picture_latency_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("fault,number", [(Stale, "planes_wrong"),
                                          (HalfLeftOut, "pictures_missing"),
                                          (OneSample, "planes_wrong"),
                                          (ControlProgram, "planes_wrong")])
def test_a_fault_is_not_correct(tiny_cell, fault, number):
    r = _run(tiny_cell, fault)
    assert not r["correct"]
    assert r["checks"][number]["value"] > r["checks"][number]["limit"]


def test_a_traced_run_reads_the_span_metrics(tiny_cell):
    r = run.run_cell(tiny_cell, 5, 2.0, True, device="cpu")
    assert r["correct"]
    assert {"stage_a_ms", "pack_ms", "dispatch_ms",
            "fetch_ms"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_judge_counts_one_changed_sample():
    planes = [np.zeros((4, 8), np.uint8), np.ones((2, 4), np.uint8)]
    ref = {0: [check.plane_digests(planes, 8)]}
    bent = [planes[0].copy(), planes[1]]
    bent[0][3, 7] = 1
    numbers, failed = check.judge([(0, 0)], {0: [check.plane_digests(bent,
                                                                      8)]},
                                  ref)
    assert numbers == {"planes_wrong": 1, "pictures_missing": 0}
    assert failed == 1 and not check.is_correct(numbers)
    numbers, _ = check.judge([(0, 0)], {0: [ref[0][0]]}, ref)
    assert check.is_correct(numbers)
