"""BENCHMARK.json and the benchmark's files: the contract's shapes and
characters, every name's file present, and a configuration, a cell and a
per-layer metric added as files and entries alone, found without an edit."""
import json
import re
import shutil

from perfbench.harness import core

from .conftest import ROOT, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = ROOT / "perfbench"


def load():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_names_and_units():
    b = load()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    metrics = b["end_to_end"] + b["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_has_its_files():
    b = load()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "runners" / f"{traffic['runner']}.py").exists()
        assert (BENCH / "flops" / f"{w['config']}.{traffic['runner']}.py").exists()
        assert wl["limits"], "a cell compares at least one number"
        reported = core.cell_metrics(b, w["name"], trace=False)
        assert {"setup_s"} < {m["name"] for m in reported}
        assert core.cell_metrics(b, w["name"], trace=True)
    for m in b["end_to_end"] + b["per_layer"]:
        assert hasattr(core.load_module(BENCH / "metrics" / f"{m['name']}.py"), "read")
    for path in sorted(BENCH.rglob("*")):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel and ".cache" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_configuration_cell_and_metric_are_files_alone(tmp_path, small, capsys):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric as new files and new entries of BENCHMARK.json;
    a traced run of the new cell reports the new metric."""
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns(".cache"))
    (tmp_path / "configs").symlink_to(ROOT / "configs")
    b = load()
    cfg = json.loads((BENCH / "configs" / "cmdm_enc_h3d.json").read_text())
    cfg["name"] = "cmdm_enc_small"
    (tmp_path / "perfbench" / "configs" / "cmdm_enc_small.json").write_text(json.dumps(cfg))
    shutil.copy(BENCH / "flops" / "cmdm_enc_h3d.train_loop.py",
                tmp_path / "perfbench" / "flops" / "cmdm_enc_small.train_loop.py")
    traffic = json.loads((BENCH / "traffic" / "train_store.json").read_text())
    traffic["warmup_megabatches"] = 1
    (tmp_path / "perfbench" / "traffic" / "train_store_short.json").write_text(
        json.dumps(traffic))
    cell = {"name": "cmdm_enc_small.train_store_short", "config": "cmdm_enc_small",
            "traffic": "train_store_short", "chips": 1, "why": "a test cell"}
    (tmp_path / "perfbench" / "workloads" / f"{cell['name']}.json").write_text(json.dumps(
        {"config": "cmdm_enc_small", "traffic": "train_store_short", "why": "a test cell",
         "check_steps": 3, "limits": {"loss_gap": 1e-3}}))
    (tmp_path / "perfbench" / "metrics" / "window_steps.py").write_text(
        "def read(run):\n    return float(run['steps'])\n")
    b["configs"].append({"name": "cmdm_enc_small", "source": "a test", "reduced": [],
                         "file": "perfbench/configs/cmdm_enc_small.json", "why": "a test"})
    b["workloads"].append(cell)
    b["per_layer"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "train loop",
                           "moves": "samples_per_s", "workloads": [cell["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    rc, result, err = run_cell(cell["name"], small(), capsys, root=tmp_path, trace=1)
    assert rc == 0, err[-2000:]
    assert result["metrics"]["window_steps"]["value"] == result["attempted"] > 0
    assert result["correct"], result["checks"]
