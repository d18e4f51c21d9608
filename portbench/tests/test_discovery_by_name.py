"""A cell, a configuration, a traffic mix, limits and a metric added as
files and entries of a copy of the benchmark are found by name, with no
file of the harness edited."""

import json
import os
import shutil

from portbench import harness, result, spec

ROOT = spec.ROOT


def test_new_files_are_found_by_name(tmp_path, small_cell):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pkg = tmp_path / "portbench"
    cfg = json.loads((pkg / "configs" / "cr_armnet1h.json").read_text())
    cfg.update(name="tiny_armnet1h", h=16, mlp_nhid=32)
    (pkg / "configs" / "tiny_armnet1h.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "train.json").read_text())
    traffic.update(zipf=1.2)
    (pkg / "traffic" / "train_skewed.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "tiny_armnet1h.train_skewed.json").write_text(
        json.dumps({"loss_gap": 1, "auc_gap": 1, "logit_gap": 1,
                    "grad_gap_median": 1, "nought_grad_gap": 1,
                    "change_gap": 1}))
    (pkg / "metrics" / "steps_seen.train.py").write_text(
        "def read(w):\n    return float(w.steps)\n")
    bench["configs"].append({"name": "tiny_armnet1h", "source": "x",
                             "file": "portbench/configs/tiny_armnet1h.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny_armnet1h.train_skewed",
                               "config": "tiny_armnet1h",
                               "traffic": "train_skewed", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "steps_seen.train", "unit": "steps",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny_armnet1h.train_skewed"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny_armnet1h.train_skewed", str(tmp_path))
    assert cell.config["h"] == 16 and cell.traffic["zipf"] == 1.2
    assert cell.limits["loss_gap"] == 1
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "steps_seen.train"]
    cell.config.update(nfeat=3900)
    cell.traffic.update(rows=512, batch=64)
    w, numbers, _ = harness.run(cell, 3, 0.2, False, "cpu")
    got = result.read_metrics(cell, w, traced=False)
    assert got["steps_seen.train"] == {"value": float(w.steps),
                                       "unit": "steps"}
    assert set(numbers) == set(cell.limits)
