"""A configuration, a traffic mix and a metric added as files under new
names are found by name, with no file of the harness edited."""

import json
import types

from bench_port import cell

from ._small import ROOT, tree


def test_new_config_traffic_and_metric_are_found(tmp_path):
    root = tree(tmp_path)
    b = root / "bench_port"
    cfg = json.loads((b / "configs" / "wimax_2304x1152.json").read_text())
    cfg["code"] = "1944x972"
    (b / "configs" / "wifi_1944x972.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "block_b128.json").read_text())
    (b / "traffic" / "block_b64.json").write_text(json.dumps(
        dict(tr, batch=64)))
    (b / "metrics" / "block_frames.new.py").write_text(
        "def read(ctx):\n    return float(ctx.layer['batch'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wifi_1944x972", "source": "x",
                             "file": "bench_port/configs/wifi_1944x972.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "wifi_1944x972.block_b64",
                               "config": "wifi_1944x972",
                               "traffic": "block_b64", "chips": 1,
                               "why": "x"})
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    e2e["block_p95_ms"]["workloads"].append("wifi_1944x972.block_b64")
    bench["per_layer"].append({"name": "block_frames.new", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "x", "moves": "block_p95_ms"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    bench = cell.load_benchmark(str(root))
    w = cell.workload(bench, "wifi_1944x972.block_b64")
    assert cell.load_config(bench, w["config"], str(root))["code"] == "1944x972"
    assert cell.load_traffic(w["traffic"], str(root))["batch"] == 64
    assert cell.load_kind("block_latency", str(root)).__name__ == "Run"
    names = [m["name"] for m in cell.metrics_of(bench, w["name"], True)]
    assert names == ["block_frames.new"]
    read = cell.load_reader("block_frames.new", str(root))
    assert read(types.SimpleNamespace(layer={"batch": 64})) == 64.0
    # the existing cells keep their own metrics
    e2e = [m["name"] for m in cell.metrics_of(
        bench, "wimax_2304x1152.decode_b8192", False)]
    assert e2e == ["decode_mbps", "setup_s"]


def test_a_dotted_metric_without_a_file_is_read_by_its_base(tmp_path):
    root = str(tree(tmp_path))
    ctx = types.SimpleNamespace(timeline=types.SimpleNamespace(
        window_s=2.0, busy_s=1.5))
    base = cell.load_reader("device_idle_share", root)
    assert base(ctx) == 25.0
    assert cell.load_reader("device_idle_share.new", root)(ctx) == 25.0
    # a file of the full name comes first
    (tmp_path / "bench_port" / "metrics" / "device_idle_share.new.py"
     ).write_text("def read(ctx):\n    return 1.0\n")
    assert cell.load_reader("device_idle_share.new", root)(ctx) == 1.0


def test_every_cell_finds_its_parts():
    bench = cell.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cfg = cell.load_config(bench, w["config"], ROOT)
        tr = cell.load_traffic(w["traffic"], ROOT)
        cell.load_kind(tr["kind"], ROOT)
        assert cfg["name"] == w["config"]
        per_layer = cell.metrics_of(bench, w["name"], True)
        assert per_layer, w["name"]
        for m in per_layer:
            cell.load_reader(m["name"], ROOT)
        e2e = {m["name"] for m in cell.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
