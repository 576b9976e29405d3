"""A new configuration, traffic mix or per-layer metric is a new file and
a new entry: the harness finds it by name with no other file edited."""

import json
import os
import shutil

from conftest import BENCH, ROOT


def test_new_files_are_found_by_name(tmp_path):
    from harness import spec
    from harness.readers import Context

    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("harness/spec.py", "harness/cell.py", "run.py")}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    # a new configuration file (a copy under a new name), a new mix, a new metric
    conf = json.load(open(bench / "configs" / "dolly-v2-3b.q4f16_hs.json"))
    conf["deployment"]["max_batch"] = 16
    json.dump(conf, open(bench / "configs" / "dolly-v2-3b.q4f16_hs.b16.json", "w"))
    mix = json.load(open(bench / "traffic" / "serve-chat.json"))
    mix["rate_rps"] = 1.25
    json.dump(mix, open(bench / "traffic" / "serve-slow.json", "w"))
    (bench / "metrics" / "late_s.serve.py").write_text(
        '"""How late the generator ran."""\n\n\ndef read(ctx):\n    return ctx.window.late_s\n')
    b["configs"].append({"name": "dolly-b16", "source": "https://huggingface.co/databricks/dolly-v2-3b",
                         "file": "benchmark/configs/dolly-v2-3b.q4f16_hs.b16.json", "reduced": [],
                         "why": "test"})
    b["workloads"].append({"name": "dolly-b16.serve-slow", "config": "dolly-b16",
                           "traffic": "serve-slow", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "late_s.serve", "unit": "s", "better": "lower",
                           "source": "host_clock", "layer": "scheduler",
                           "moves": "out_tok_s", "workloads": ["dolly-b16.serve-slow"]})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("dolly-b16.serve-slow")
    json.dump(b, open(tmp_path / "BENCHMARK.json", "w"))
    cell = spec.load_cell(str(tmp_path), "dolly-b16.serve-slow", str(bench))
    assert cell.deployment["max_batch"] == 16 and cell.mix["rate_rps"] == 1.25
    assert [m["name"] for m in cell.per_layer] == ["late_s.serve"]
    assert [m["name"] for m in cell.end_to_end] == ["out_tok_s", "setup_s"]

    class W:
        late_s = 0.25

    ctx = Context(cell, W, 1.0, 1.0, None, None, None, 1, False)
    assert spec.read_metrics(cell.per_layer, ctx, str(bench)) == {
        "late_s.serve": {"value": 0.25, "unit": "s"}}
    # nothing of the harness was touched
    for p, data in before.items():
        assert open(os.path.join(BENCH, p), "rb").read() == data


def test_every_named_file_exists():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]
