"""The benchmark is data: every cell, configuration and metric that
BENCHMARK.json names is a file found by its name."""
from __future__ import annotations

import json

import pytest

import run
from pb import spec

ROOT = spec.HERE.parent
BENCH = spec.load_benchmark(ROOT)


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_traffic_config_and_readers(w):
    cell = spec.cell(BENCH, w)
    traffic = spec.traffic(cell["traffic"])
    assert spec.driver(traffic["driver"])
    config = spec.config(spec.config_entry(BENCH, cell["config"]), ROOT)
    assert config["files"]
    e2e = {m["name"] for m in spec.metrics_of(BENCH, w, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.metrics_of(BENCH, w, "per_layer")
    assert layers
    for m in layers:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in e2e


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_a_new_traffic_and_metric_are_found_by_name(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic" / "bulk_b8.json").write_text(json.dumps(
        {"driver": "bulk", "texts": 8}))
    (tmp_path / "metrics" / "x_ms.py").write_text(
        "def read(ctx):\n    return ctx.get('x')\n")
    assert spec.traffic("bulk_b8", tmp_path)["texts"] == 8
    read = spec.reader("x_ms.bulk", tmp_path)
    assert read({"x": 3.0}) == 3.0 and read({}) is None


def test_per_layer_metrics_without_a_list_follow_their_end_to_end_metric():
    bench = {"end_to_end": [{"name": "a", "workloads": ["w1"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "p", "moves": "a"},
                           {"name": "q", "moves": "a", "workloads": ["w2"]}]}
    assert [m["name"] for m in spec.metrics_of(bench, "w1", "per_layer")] == ["p"]
    assert [m["name"] for m in spec.metrics_of(bench, "w2", "end_to_end")] == ["setup_s"]


def test_run_refuses_a_machine_without_a_card(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "ar_bulk_b64", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""


def test_run_refuses_a_directory_without_the_program(tmp_path, capsys,
                                                     monkeypatch):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(BENCH))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "ar_bulk_b64", "--seed", "1", "--seconds",
                  "1", "--trace", "0"])
    assert e.value.code == 2
    assert capsys.readouterr().out == ""
