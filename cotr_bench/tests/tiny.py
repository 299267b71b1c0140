"""A small copy of the benchmark for the tests: the harness and its files in
a temporary directory, with cells of the real entries at sizes a CPU run
holds (1 + 1 layers of random weights, or the flagship on the card, small
images, few queries)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

SMALL = {"image_hw": [256, 256], "margin": 8, "angle_deg": 4.0,
         "scale": [0.95, 1.05], "shift_px": 20.0,
         "zoom_linspace": [0.5, 0.25, 2],
         "engine": {"mode": "tile", "seed_stride": 8}}
TRAFFIC = {
    "single_pair": dict(entry="single_pair", loop="closed", pool=1,
                        queries=12, **SMALL),
    "multipair": dict(entry="multipair", loop="closed", pairs_per_call=2,
                      pool=2, queries=6, **SMALL),
    "cycle": dict(entry="cycle", loop="closed", pool=1, queries=0,
                  max_corrs=6, **SMALL),
    "train": dict(entry="train", loop="closed", batch=2, num_kp=8,
                  bidirectional=True, pool=4, checked_steps=3,
                  angle_deg=12.0, scale=[0.9, 1.12], shift_px=14.0),
}
# each small cell is held to the limits of the real cell of its entry
LIMITS = {"single_pair": "squad_guided.f32",
          "multipair": "squad_multipair.bf16",
          "cycle": "scan_cycle.f32", "train": "train_b24.f32"}


def random_weights(path: Path, layers=(1, 1)) -> None:
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.checkpoint_io import save_params_npz
    from cotr_tpu_torch.models.cotr import build_model, init_weights

    model = build_model(COTRConfig(enc_layers=layers[0],
                                   dec_layers=layers[1]))
    init_weights(model, torch.Generator().manual_seed(0))
    save_params_npz(model, str(path), dtype="float32")


def make_root(tmp: Path, entries=("single_pair", "train"),
              flagship: bool = False, traffic=None) -> Path:
    """The copy: ``BENCHMARK.json`` with one cell ``small.<entry>`` a
    given entry, the harness, a config ``small`` and its weights."""
    tmp = Path(tmp)
    shutil.copytree(BENCH, tmp / "cotr_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((BENCH / "configs" / "cotr_r50l3_f32.json")
                        .read_text())
    if flagship:
        config["weights"] = str(REPO / config["weights"])
    else:
        (tmp / "w").mkdir()
        random_weights(tmp / "w" / "small.npz")
        config["weights"] = "w/small.npz"
        config["model"].update(enc_layers=1, dec_layers=1)
    (tmp / "cotr_bench/configs/small.json").write_text(json.dumps(config))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry_of = {c["name"]: json.loads(
        (BENCH / "traffic" / f"{c['traffic']}.json").read_text())["entry"]
        for c in bench["workloads"]}
    bench["configs"] = [{"name": "small", "source": "test",
                         "file": "cotr_bench/configs/small.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for entry in entries:
        t = dict(TRAFFIC[entry], **(traffic or {}).get(entry, {}))
        (tmp / f"cotr_bench/traffic/small_{entry}.json").write_text(
            json.dumps(t))
        name = f"small.{entry}"
        bench["workloads"].append({"name": name, "config": "small",
                                   "traffic": f"small_{entry}", "chips": 1,
                                   "why": "test"})
        shutil.copy(BENCH / "limits" / f"{LIMITS[entry]}.json",
                    tmp / "cotr_bench" / "limits" / f"{name}.json")
    # a metric of some cells goes to the small cells of their entries
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [f"small.{e}" for e in entries
                              if any(entry_of[w] == e
                                     for w in m["workloads"])]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
