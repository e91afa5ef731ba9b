"""A configuration, a traffic mix, a cell and a per-layer metric are files
and entries, found by name: adding them edits no existing file."""
import json
import sys

from portbench import run

from portbench.tests.conftest import small, write_json


def test_new_files_are_found_by_name(tree, cpu, monkeypatch):
    pb = tree / "portbench"
    cfg = json.loads((pb / "configs" / "minidish.json").read_text())
    cfg["name"] = "minidish_deep"
    cfg["homogenizer"]["depth_m"] = 0.9
    write_json(pb / "configs" / "minidish_deep.json", cfg)
    traffic = json.loads((pb / "traffic" / "bundle.json").read_text())
    traffic["name"] = "bundle_short"
    traffic["max_bounces"] = 12
    write_json(pb / "traffic" / "bundle_short.json", traffic)
    (pb / "metrics" / "calls_seen.py").write_text(
        "def read(run):\n    return run.n_calls\n")
    monkeypatch.setattr(sys.modules["portbench.metrics"], "__path__",
                        [str(pb / "metrics")])
    write_json(pb / "limits" / "deep-bundle.json", json.loads(
        (pb / "limits" / "minidish-bundle.json").read_text()))
    bench = json.loads((tree / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][1], name="minidish_deep",
                                 file="portbench/configs/minidish_deep.json"))
    bench["workloads"].append({"name": "deep-bundle",
                               "config": "minidish_deep",
                               "traffic": "bundle_short", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if "minidish-bundle" in m.get("workloads", []):
            m["workloads"].append("deep-bundle")
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "round loop", "moves": "rays_per_s",
                               "workloads": ["deep-bundle"]})
    write_json(tree / "BENCHMARK.json", bench)
    res = run.run(bench, "deep-bundle", 5, 0.2, True, cpu,
                  small(bench, "minidish-bundle"))
    assert res["correct"], res["checks"]
    assert "calls_seen" in res["metrics"]
    assert set(res["metrics"]) == {m["name"] for m in run.metrics_for(
        bench, "deep-bundle", "per_layer")}


def test_every_per_layer_metric_has_a_reader(bench):
    import importlib
    for m in bench["per_layer"]:
        reader = importlib.import_module(
            "portbench.metrics." + m["name"].split(".")[0])
        assert callable(reader.read)
