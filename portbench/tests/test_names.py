"""The harness finds everything by name: every cell's configuration,
traffic, driver, generator, limits and per-layer readers resolve to files;
names and units keep to the contract's characters; each per-layer metric
is reported only in cells that report the end-to-end metric it moves. A
throwaway cell added as new files and entries in a copy resolves too."""

import json
import shutil
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def resolve(root: Path) -> dict:
    """Every file each cell needs, resolved by name; raises on an unknown
    name or a character outside the allowed set."""
    bench = harness.benchmark(root)
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert harness.NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert harness.UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in E2E_SOURCES
        assert 0 < m["bound"] <= 0.25
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    out = {}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        cfg_file = root / configs[w["config"]]["file"]
        assert cfg_file == harness.config_path(w["config"], root)
        cfg = harness.load_json(cfg_file)
        traffic = harness.load_json(harness.traffic_path(w["traffic"], root))
        files = [harness.driver_path(traffic["driver"], root),
                 harness.generator_path(traffic["generator"], root)]
        limits = harness.load_json(harness.limits_path(w["name"], root))
        assert limits and all(v >= 0 for v in limits.values())
        reported = {m["name"] for m in harness.end_to_end_of(bench,
                                                               w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = harness.per_layer_of(bench, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in reported, (m["name"], w["name"])
            assert m["source"] in SOURCES
            files.append(harness.metric_path(m["name"], root))
            reader = harness.load_module(files[-1], "reader")
            assert (reader.LAYER, reader.UNIT) == (m["layer"], m["unit"])
        for f in files:
            assert f.is_file(), f
        out[w["name"]] = {"cfg": cfg, "traffic": traffic, "files": files}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    return out


def test_every_cell_resolves():
    cells = resolve(ROOT)
    assert "voc320-train-b64" in cells


def test_configs_hold_their_keys():
    bench = harness.benchmark(ROOT)
    for c in bench["configs"]:
        cfg = harness.load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["source"] == cfg["source"]


def test_a_new_cell_is_files_and_entries(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark(ROOT)
    bench["configs"].append({
        "name": "refinedet512-voc",
        "source": "https://arxiv.org/abs/1711.06897",
        "file": "portbench/configs/refinedet512-voc.json", "reduced": [],
        "why": "a throwaway configuration"})
    cfg = harness.load_json(harness.config_path("refinedet320-voc", ROOT))
    cfg.update(name="refinedet512-voc", size=512)
    (tmp_path / "portbench/configs/refinedet512-voc.json").write_text(
        json.dumps(cfg))
    traffic = harness.load_json(harness.traffic_path("sar-detect-b16", ROOT))
    traffic.update(batch=8, generator="scenes",
                   scene={"objects_mean": 2.4, "objects_max": 42,
                          "side_min": 0.02, "side_max": 0.9})
    (tmp_path / "portbench/traffic/detect-b8.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits/voc512-detect-b8.json").write_text(
        json.dumps({"score_gap": 0.1, "missed": 0.1}))
    (tmp_path / "portbench/metrics/calls.detect.py").write_text(
        'LAYER = "serving artifact"\nUNIT = "calls"\n\n\ndef read(rec):\n'
        '    return rec["window"]["steps"]\n')
    bench["workloads"].append({
        "name": "voc512-detect-b8", "config": "refinedet512-voc",
        "traffic": "detect-b8", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "calls.detect", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "serving artifact",
        "moves": "detect_images_per_s", "workloads": ["voc512-detect-b8"]})
    for m in bench["end_to_end"]:
        if m["name"] == "detect_images_per_s":
            m["workloads"].append("voc512-detect-b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cells = resolve(tmp_path)
    assert cells["voc512-detect-b8"]["cfg"]["size"] == 512
    reader = harness.load_module(
        harness.metric_path("calls.detect", tmp_path), "r")
    assert reader.read({"window": {"steps": 7}}) == 7


def test_an_unknown_name_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark(ROOT)
    bench["workloads"][0]["traffic"] = "no-such-mix"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError):
        resolve(tmp_path)
    bench["workloads"][0]["traffic"] = "bad name"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(AssertionError):
        resolve(tmp_path)


def test_a_layer_metric_in_a_cell_without_its_metric_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark(ROOT)
    for m in bench["per_layer"]:
        if m["name"] == "mfu.train":
            m["workloads"].append(bench["workloads"][1]["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(AssertionError):
        resolve(tmp_path)
