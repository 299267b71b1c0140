"""The paper's training story end to end on generated COLMAP scenes
(counterpart of tools/run_generated_training.py).

MegaDepth is not at hand, so this orchestrator writes disjoint COLMAP
scenes with images, depths and cameras (``tools/bench_loader.
generate_scene``) and drives the port's production path through them:

  COLMAP parse -> kNN retrieval -> occlusion-checked supervision ->
  stage 1 (device-synth supervision), preempted by SIGTERM once it has
  passed ``--valid_iter`` and resumed with ``--resume yes`` ->
  stage 2 (batch 16, backbone rate 1e-5) ->
  stage 3 (the zoom dataset, no_crop) ->
  ``eval_megadepth`` on the held-out scene.

Each stage is ``python -m cotr_tpu_torch.tools.train_cotr`` (the eval
``python -m cotr_tpu_torch.tools.eval_megadepth``) in a subprocess with the
JAX tool's flags; a stage's weights are its Trainer's
``checkpoints/checkpoint.pt``. Writes ``summary.json`` (the loss
trajectories, the resume step numbers, the held-out EPE) under ``--out``.

  python -m cotr_tpu_torch.tools.run_generated_training --root /tmp/gen_md \\
      --out out/gen_training --init_weights checkpoints/flagship.npz

It runs the stages on the card; ``main(argv, device="cpu")`` runs them on
the CPU (each subprocess calls the tool's ``main`` with that device).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import tempfile
import time
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the batch of stages 1, 2 and 3 (the paper's, fixed as in the JAX tool)
STAGE_BATCHES = (24, 16, 16)


def run_stage(cmd, log_path, kill_after_iter=None):
    """Run a train_cotr stage, streaming its output to ``log_path``;
    optionally SIGTERM it once 'iter N' with N >= kill_after_iter appears
    (the preemption of the resume proof). Returns (returncode, iters) with
    iters = [(step, train_loss, val_loss), ...]."""
    iters = []
    # val can print as 'nan' (a val split smaller than the batch yields no
    # val batch), so match any token and let float() parse it
    pat = re.compile(r"iter (\d+): loss=(\S+) val=(\S+)")
    with open(log_path, "a") as log:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=REPO)
        killed = False
        for line in proc.stdout:
            log.write(line)
            log.flush()
            m = pat.search(line)
            if m:
                iters.append((int(m.group(1)), float(m.group(2)),
                              float(m.group(3))))
                if (kill_after_iter is not None and not killed
                        and iters[-1][0] >= kill_after_iter):
                    proc.send_signal(signal.SIGTERM)
                    killed = True
        proc.wait()
        return proc.returncode, iters


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "gen_md"))
    ap.add_argument("--out", default="out/gen_training")
    ap.add_argument("--train_caps", type=int, default=400,
                    help="captures PER TRAIN SCENE")
    ap.add_argument("--val_caps", type=int, default=100)
    ap.add_argument("--train_scenes", type=int, default=1,
                    help="disjoint train scenes (each its own procedural "
                         "plane texture); texture diversity across scenes "
                         "is what makes the held-out scene's val loss fall "
                         "instead of memorizing one texture")
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--stage1_iters", type=int, default=600)
    ap.add_argument("--stage2_iters", type=int, default=400)
    ap.add_argument("--stage3_iters", type=int, default=300)
    ap.add_argument("--valid_iter", type=int, default=100)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--enc_layers", type=int, default=6,
                    help="model depth for the stages (shrink for CPU runs "
                         "of the orchestrator itself)")
    ap.add_argument("--dec_layers", type=int, default=6)
    ap.add_argument("--reuse_scenes", action="store_true")
    ap.add_argument("--init_weights", default=None,
                    help="warm-start stage 1 from a published .npz (e.g. "
                         "checkpoints/flagship.npz) so the held-out EPE "
                         "reflects a capable model")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    from cotr_tpu_torch.tools.bench_loader import generate_scene, image_name
    from cotr_tpu_torch.utils.device import module_command

    args = parse_args(argv)
    # the stages run from the repository's root: paths are made absolute
    args.root, args.out = os.path.abspath(args.root), \
        os.path.abspath(args.out)
    if args.init_weights:
        args.init_weights = os.path.abspath(args.init_weights)
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "stages.log")
    bs1, bs2, bs3 = (str(b) for b in STAGE_BATCHES)

    # ---- N disjoint train scenes and one held-out val scene under one root
    # (path-prefix matching needs a shared root); each scene renders its own
    # procedural plane texture (generate_scene's seed)
    t0 = time.time()
    train_names = [f"{i + 1:04d}" for i in range(args.train_scenes)]
    val_name = f"{args.train_scenes + 1:04d}"
    skip = args.reuse_scenes and os.path.exists(
        os.path.join(args.root, val_name))
    for i, sn in enumerate(train_names):
        generate_scene(args.root, args.train_caps, args.height, args.width,
                       seed=i, scene_name=sn, write_jsons=False,
                       skip_files=skip)
    generate_scene(args.root, args.val_caps, args.height, args.width,
                   seed=777, scene_name=val_name, write_jsons=False,
                   skip_files=skip)
    rel_a = [f"{sn}/dense/imgs/{image_name(i)}"
             for sn in train_names for i in range(args.train_caps)]
    rel_b = [f"{val_name}/dense/imgs/{image_name(i)}"
             for i in range(args.val_caps)]
    with open(os.path.join(args.root, "valid_list.json"), "w") as f:
        json.dump(rel_a + rel_b, f)
    with open(os.path.join(args.root, "train.json"), "w") as f:
        json.dump(rel_a, f)
    with open(os.path.join(args.root, "val.json"), "w") as f:
        json.dump(rel_b, f)
    # the depths sit beside the images (COLMAP .geometric.bin)
    dcfg = {
        "scenes_name_list": [
            {"scene_dir": os.path.join(args.root, sn, "dense", "sparse"),
             "image_dir": os.path.join(args.root, sn, "dense", "imgs"),
             "depth_dir": os.path.join(args.root, sn, "dense", "imgs")}
            for sn in train_names + [val_name]],
        "valid_list_json": os.path.join(args.root, "valid_list.json"),
        "train_json": os.path.join(args.root, "train.json"),
        "val_json": os.path.join(args.root, "val.json"),
        "test_json": os.path.join(args.root, "val.json"),
    }
    dcfg_path = os.path.join(args.root, "dataset_config.json")
    with open(dcfg_path, "w") as f:
        json.dump(dcfg, f, indent=1)
    print(f":: scenes ready in {time.time() - t0:.0f}s", flush=True)

    summary = {"scenes": {"train_scenes": args.train_scenes,
                          "train_caps_per_scene": args.train_caps,
                          "val_caps": args.val_caps,
                          "rendered": "world-texture projected through "
                                      "cameras (content-consistent)",
                          "hw": [args.height, args.width]},
               "stages": {}}
    base = module_command("cotr_tpu_torch.tools.train_cotr", device) + [
        "--dataset_config", dcfg_path, "--confirm", "no",
        "--dtype", args.dtype, "--valid_iter", str(args.valid_iter),
        "--out_dir", os.path.join(args.out, "runs"),
        "--enc_layers", str(args.enc_layers),
        "--dec_layers", str(args.dec_layers),
        "--use_ram", "yes"]

    def ckpt_of(suffix):
        runs = os.path.join(args.out, "runs")
        for d in sorted(os.listdir(runs)):
            if d.endswith(f"suffix:{suffix}"):
                return os.path.join(runs, d, "checkpoints", "checkpoint.pt")
        raise FileNotFoundError(suffix)

    # ---- stage 1 (reference: bs 24, frozen pretrained backbone; from
    # scratch the backbone must train, lr_backbone = lr) with device-synth
    # supervision, preempted mid-run then resumed (the reference's
    # use_cc / cc_resume story)
    s1 = base + ["--batch_size", bs1, "--learning_rate", "1e-4",
                 "--lr_backbone", "1e-4", "--max_iter",
                 str(args.stage1_iters), "--suffix", "gen1",
                 "--device_synth", "yes"]
    if args.init_weights:
        s1 += ["--load_weights_path", args.init_weights]
        summary["init_weights"] = args.init_weights
    t0 = time.time()
    rc, it_a = run_stage(s1, log_path,
                         kill_after_iter=args.valid_iter)
    print(f":: stage 1 leg A rc={rc} iters={len(it_a)} "
          f"({time.time() - t0:.0f}s)", flush=True)
    assert it_a, "stage 1 produced no iterations"
    rc, it_b = run_stage(s1 + ["--resume", "yes"], log_path)
    assert rc == 0, f"stage 1 resume leg failed rc={rc}"
    assert it_b and it_b[0][0] > it_a[-1][0] >= args.valid_iter, (
        "resume did not continue from the preempted step",
        it_a[-1], it_b[0])
    summary["stages"]["stage1"] = {
        "iters_leg_a": it_a, "iters_leg_b": it_b,
        "resume_proof": {"preempted_at": it_a[-1][0],
                         "resumed_first_val": it_b[0][0]}}

    # ---- stage 2 (reference: bs 16, backbone lr 1e-5)
    s2 = base + ["--batch_size", bs2, "--learning_rate", "1e-4",
                 "--lr_backbone", "1e-5", "--max_iter",
                 str(args.stage2_iters), "--suffix", "gen2",
                 "--load_weights_path", ckpt_of("gen1")]
    t0 = time.time()
    rc, it2 = run_stage(s2, log_path)
    assert rc == 0 and it2, f"stage 2 failed rc={rc}"
    print(f":: stage 2 rc={rc} ({time.time() - t0:.0f}s)", flush=True)
    summary["stages"]["stage2"] = {"iters": it2}

    # ---- stage 3 (reference: zoom dataset, crop_cam=no_crop, bs 16)
    s3 = base + ["--batch_size", bs3, "--learning_rate", "1e-4",
                 "--lr_backbone", "1e-5", "--max_iter",
                 str(args.stage3_iters), "--suffix", "gen3",
                 "--enable_zoom", "yes", "--crop_cam", "no_crop",
                 "--use_ram", "no",
                 "--load_weights_path", ckpt_of("gen2")]
    t0 = time.time()
    rc, it3 = run_stage(s3, log_path)
    assert rc == 0 and it3, f"stage 3 failed rc={rc}"
    print(f":: stage 3 rc={rc} ({time.time() - t0:.0f}s)", flush=True)
    summary["stages"]["stage3"] = {"iters": it3}

    # ---- held-out eval: dense-grid EPE on pairs of the unseen scene
    eval_out = os.path.join(args.out, "eval_megadepth.json")
    with open(log_path, "a") as log:
        rc = subprocess.run(
            module_command("cotr_tpu_torch.tools.eval_megadepth", device)
            + ["--dataset_config", dcfg_path,
               "--load_weights_path", ckpt_of("gen3"),
               "--dtype", args.dtype, "--pairs", "6", "--grid", "24",
               "--zoom_depth", "3", "--out", eval_out],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT).returncode
    assert rc == 0, "eval_megadepth failed"
    with open(eval_out) as f:
        summary["heldout_eval"] = json.load(f)

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"stage1_first_last": [it_a[0], it_b[-1]],
                      "stage2_first_last": [it2[0], it2[-1]],
                      "stage3_first_last": [it3[0], it3[-1]],
                      "heldout_eval": summary["heldout_eval"]}, indent=1))
    return summary


if __name__ == "__main__":
    main()
