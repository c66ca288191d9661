"""``BENCHMARK.json`` keeps to the benchmark's contract: legal names and
units, every cell's configuration, traffic and bank present, every
``workloads`` list naming cells that exist, and a reader for every
per-layer metric."""
import json
import os
import re

from benchmark import bank

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
M = bank.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_and_paths():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(bank.MANIFEST) <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16
    for p in M["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(bank.ROOT, p))
    assert 1 <= len(M["command"]) <= 32
    for word in M["command"]:
        assert _line(word) and not word.startswith("/") and ".." not in word
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        assert 1 <= len(M[group])
        for e in M[group]:
            assert set(e) <= keys and set(e) >= keys - {"workloads"}, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert _line(e[k]), (e["name"], k)


def test_configs_and_cells_exist():
    cells = {w["name"] for w in M["workloads"]}
    used = {w["config"] for w in M["workloads"]}
    files = [c["file"] for c in M["configs"]]
    assert len(set(files)) == len(files)
    for c in M["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in M["paths"])
        cfg = bank.load_json(os.path.join(bank.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert cfg["guarantee"] and cfg["assumed"]
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(bank.HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(
            bank.bank_dir(w["config"], w["traffic"]), "bank.json"))
    for m in M["end_to_end"] + M["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]


def test_metrics_each_cell_reports():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(bank.HERE, "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in M["workloads"]:
        def reports(m):
            return w["name"] in m.get("workloads", [w["name"]])
        got = [m["name"] for m in e2e.values() if reports(m)]
        assert "setup_s" in got and len(got) >= 2
        pl = [m for m in M["per_layer"] if reports(m)]
        assert pl
        for m in pl:  # each reports the end-to-end metric it moves
            assert m["moves"] in got


def test_manifest_is_json_the_harness_reads():
    with open(bank.MANIFEST) as f:
        assert json.load(f) == M
