"""On the card: one short run of each cell through the command
``BENCHMARK.json`` names prints a correct result line."""
import json
import os
import subprocess

import pytest

from benchmark import bank


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"]
                                  for w in bank.manifest()["workloads"]])
def test_a_short_run_is_correct(card, cell):
    cmd = bank.manifest()["command"] + ["--workload", cell, "--seed", "7",
                                        "--seconds", "3", "--trace", "0"]
    r = subprocess.run(cmd, cwd=bank.ROOT, capture_output=True, text=True,
                       timeout=1200, env=dict(os.environ))
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
