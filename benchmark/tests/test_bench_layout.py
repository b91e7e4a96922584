"""BENCHMARK.json against the contract's form, and the harness finding each
piece by its name."""
import json
import re
import shutil

import pytest
from conftest import BENCH, ROOT

import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
CELLS = [w["name"] for w in SPEC["workloads"]]


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    bench = harness.Bench(ROOT)
    w = bench.cell(cell)
    assert w["chips"] == 1
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{cell}.json").is_file()
    names = [m["name"] for m in bench.metrics(cell, False)]
    assert "setup_s" in names and len(names) >= 2
    assert bench.metrics(cell, True)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form_and_reader(metric):
    keys = {"name", "unit", "better", "bound", "source"} if "bound" in metric else \
        {"name", "unit", "better", "source", "layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert harness.Bench(ROOT).reader(metric["name"]).is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        moved = E2E[metric["moves"]]
        for cell in metric.get("workloads", CELLS):
            assert reports(moved, cell), (metric["name"], cell)
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]


@pytest.mark.parametrize("entry", SPEC["configs"] + SPEC["workloads"],
                         ids=lambda e: e["name"])
def test_names_and_whys(entry):
    assert NAME.match(entry["name"])
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    if "file" in entry:
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("benchmark/") and (ROOT / entry["file"]).is_file()
        assert len(entry["reduced"]) <= 16
    else:
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"])


def test_a_new_config_mix_and_metric_are_found_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as new
    files and entries; nothing that is there is edited."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((BENCH / "configs" / "flagship.json").read_text())
    cfg["name"] = "flagship_b"
    (tmp_path / "benchmark/configs/flagship_b.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/traffic/fit_pair.json").write_text(
        json.dumps({"kind": "fit", "datasets": 2, "fused": True}))
    (tmp_path / "benchmark/traffic/echo_once.json").write_text(json.dumps({"kind": "echo"}))
    (tmp_path / "benchmark/kinds/echo.py").write_text(
        "from drive import BaseLoop\n\n\nclass Loop(BaseLoop):\n    def item(self, i):\n"
        "        return {'wall': 0.0}\n")
    (tmp_path / "benchmark/metrics/fits_done.py").write_text(
        "def read(run):\n    return float(len(run.items))\n")
    spec["configs"].append(dict(SPEC["configs"][0], name="flagship_b",
                                file="benchmark/configs/flagship_b.json"))
    spec["workloads"].append({"name": "flagship_b.pair", "config": "flagship_b",
                              "traffic": "fit_pair", "chips": 1, "why": "x"})
    spec["workloads"].append({"name": "flagship_b.echo", "config": "flagship_b",
                              "traffic": "echo_once", "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "fits_done", "unit": "fits", "better": "higher",
                              "source": "host_clock", "layer": "api.fit", "moves": "setup_s",
                              "workloads": ["flagship_b.pair"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tmp_path)
    assert bench.config("flagship_b")["name"] == "flagship_b"
    assert bench.traffic("fit_pair")["datasets"] == 2
    assert [m["name"] for m in bench.metrics("flagship_b.pair", True)] == ["fits_done"]

    class Fake:
        items = [1, 2, 3]

    reader = harness.load_module(bench.reader("fits_done"))
    assert reader.read(Fake()) == 3.0
    assert bench.reader("fits_done.echo") == bench.reader("fits_done")

    import drive

    args = harness.parse(["--workload", "flagship_b.echo", "--seed", "3", "--seconds", "0"])
    loop = drive.make_loop(harness.Run(args, bench, None, None, 0.0))
    assert loop.item(0) == {"wall": 0.0} and loop.check_index == 0


def test_limits_name_numbers_the_check_computes():
    known = re.compile(r"^(it0|it1|m1|h0|hf|final)\.(mu|v|a|b|omega|sigma|amp)$|^lono\.score$"
                       r"|^(fits|passes)_nonfinite$")
    for cell in CELLS:
        limits = json.loads((BENCH / "limits" / f"{cell}.json").read_text())
        assert limits and all(known.match(k) for k in limits), cell
        assert all(v >= 0 for v in limits.values())
