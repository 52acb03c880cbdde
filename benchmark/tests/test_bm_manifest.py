"""BENCHMARK.json against the contract's rules, and every file it names."""
import json
import os
import re


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == KEYS
    assert m["paths"] == ["benchmark"]
    assert m["command"] == ["python3", "benchmark/run.py"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_lines():
    m = manifest()
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in m["workloads"]]:
        assert NAME.match(n), n
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x
        assert x["better"] in ("lower", "higher")
    for text in ([w["why"] for w in m["workloads"]]
                 + [c["why"] for c in m["configs"]]
                 + [c["source"] for c in m["configs"]]
                 + [x["layer"] for x in m["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_configuration_has_a_cell_and_its_files():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for k in c["reduced"]:
            assert k in cfg and NAME.match(k)
    for w in m["workloads"]:
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           f"{w['traffic']}.json"))


def test_metrics_have_readers_and_their_moves_are_reported():
    m = manifest()
    cells = [w["name"] for w in m["workloads"]]
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["end_to_end"] + m["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           f"{x['name']}.py")), x["name"]
    for x in m["per_layer"]:
        moved = e2e[x["moves"]]
        for c in x.get("workloads", cells):
            assert c in cells
            assert c in moved.get("workloads", cells), (x["name"], c)
    for c in cells:
        reported = [x for x in m["end_to_end"] if c in x.get("workloads", cells)]
        assert "setup_s" in [x["name"] for x in reported]
        assert len(reported) >= 2
        assert any(c in x.get("workloads", cells) for x in m["per_layer"])


def test_one_layer_name_per_module_group():
    layers = {x["layer"] for x in manifest()["per_layer"]}
    assert all(1 <= len(layer) <= 200 for layer in layers)


def test_a_full_check_fits_with_24_cells():
    rs = manifest()["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
