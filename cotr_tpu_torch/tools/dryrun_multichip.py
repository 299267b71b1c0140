"""Multi-rank dry run of the full train step (counterpart of
``__graft_entry__.dryrun_multichip`` and ``tools/dryrun_fulldepth.py``).

Starts N processes, one rank each (gloo on the CPU; NCCL on the cards, one
each, where there are N: NCCL puts no two ranks on one card). Each builds
the model at ``--enc_layers``/``--dec_layers`` (6 + 6 for the full-depth
run) and lays it out as the JAX dry run does: a 2-D ``(data, model)`` mesh
with Megatron tensor parallelism over the transformer and ZeRO-1 over
``data`` for the replicated parameters' moments when N >= 4 and N is even,
else pure data parallelism. Then one full train step on tiny inputs:
forward, cycle forward, backward, Adam with the parameter groups. Rank 0
prints the counts of moment tensors (``mu`` and ``nu`` of each trained
parameter) on ``"model"``, on ``"data"`` and replicated, and the loss.

  python -m cotr_tpu_torch.tools.dryrun_multichip --n 4 --device cpu \\
      [--enc_layers 6 --dec_layers 6] [--out dryrun.json]

By default it runs on the cards; ``--device cpu`` or
``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Optional, Sequence

import numpy as np
import torch

#: seconds the ranks may take before they are killed
TIMEOUT_S = 900
#: torch threads a rank on the CPU, where the ranks share the host's cores
CPU_THREADS = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8, help="ranks")
    ap.add_argument("--enc_layers", type=int, default=1)
    ap.add_argument("--dec_layers", type=int, default=1)
    ap.add_argument("--out", default=None, help="write rank 0's report here")
    ap.add_argument("--device", default=None,
                    help="cpu (gloo) or cuda (NCCL); default: the card")
    return ap.parse_args(argv)


def uses_tp(n: int) -> bool:
    """The JAX dry run's choice: a (data, model) mesh when n allows it."""
    return n >= 4 and n % 2 == 0


def _rank(rank: int, n: int, store_path: str, device: str, args_dict: dict,
          out_path: str) -> None:
    from cotr_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(CPU_THREADS)
    try:
        store = torch.distributed.FileStore(store_path, n)
        init_distributed(device, store=store, rank=rank, world_size=n)
        try:
            report = _step(n, args_dict)
        finally:
            torch.distributed.destroy_process_group()
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(report, f)
    except BaseException:  # reported by main, which fails
        with open(f"{out_path}.err{rank}", "w") as f:
            f.write(traceback.format_exc())
        raise


def _step(n: int, a: dict) -> dict:
    from cotr_tpu_torch.config import COTRConfig, TrainConfig
    from cotr_tpu_torch.models.cotr import build_model
    from cotr_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from cotr_tpu_torch.parallel.tp import make_2d_mesh
    from cotr_tpu_torch.training import train_step as ts

    t0 = time.perf_counter()
    tp = uses_tp(n)
    mesh = make_2d_mesh(n, model_parallel=2) if tp else make_mesh(n)
    model_cfg = COTRConfig(enc_layers=a["enc_layers"],
                           dec_layers=a["dec_layers"], dropout=0.1)
    train_cfg = TrainConfig(batch_size=n, num_devices=n)
    batch = {
        "image": torch.zeros((n, 256, 512, 3)),
        "queries": torch.tensor([[0.25, 0.5], [0.7, 0.3]]).repeat(n, 1, 1),
        "targets": torch.tensor([[0.75, 0.5], [0.2, 0.3]]).repeat(n, 1, 1),
    }
    state = ts.create_train_state(
        build_model(model_cfg), train_cfg, torch.Generator().manual_seed(0),
        mesh.device, mesh, zero1_axis="data" if tp else None)
    layouts = state.optimizer.moment_layouts.values()
    counts = {"model": 2 * sum(lay.axis == "model" for lay in layouts),
              "data": 2 * sum(lay.axis == "data" for lay in layouts),
              "replicated": 2 * sum(lay.replicated for lay in layouts)}
    if tp and not (counts["model"] and counts["data"]):
        raise AssertionError(f"moments not split on both axes: {counts}")
    step = ts.make_train_step(train_cfg, mesh)
    # model peers draw the same masks for the activations they share
    generator = torch.Generator(device=mesh.device).manual_seed(
        1 + mesh.coordinate("data"))
    state, metrics = step(state, shard_batch(batch, mesh), generator)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss: {loss}")
    if state.step != 1 or int(state.optimizer.count) != 1:
        raise AssertionError("the step was not applied")
    return {"ok": True, "n_devices": n, "mesh": mesh.shape,
            "layout": "dp x tp" if tp else "dp", "loss": loss,
            "moments": counts, "enc_layers": a["enc_layers"],
            "dec_layers": a["dec_layers"], "device": str(mesh.device.type),
            "wall_s": time.perf_counter() - t0}


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    args = parse_args(argv)
    from cotr_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device or device)
    if dev.type == "cuda" and torch.cuda.device_count() < args.n:
        raise ValueError(f"{args.n} ranks need {args.n} cards, "
                         f"{torch.cuda.device_count()} present (NCCL puts "
                         "no two ranks on one card); run with the CPU")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(
            r, args.n, os.path.join(tmp, "store"), dev.type, vars(args),
            out_path)) for r in range(args.n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = [open(os.path.join(tmp, name)).read()
                  for name in sorted(os.listdir(tmp)) if ".err" in name]
        codes = [p.exitcode for p in procs]
        if errors or any(c != 0 for c in codes) or \
                not os.path.exists(out_path):
            raise RuntimeError(f"dryrun_multichip({args.n}) failed, exit "
                               f"codes {codes}\n" + "\n".join(errors))
        with open(out_path) as f:
            report = json.load(f)
    report["total_s"] = time.perf_counter() - t0
    m = report["moments"]
    if report["layout"] == "dp x tp":
        print(f"opt-state shardings: {m['model']} moment tensors on 'model' "
              f"(TP), {m['data']} on 'data' (ZeRO-1), {m['replicated']} "
              "replicated")
    print(f"dryrun_multichip({args.n}) OK: loss={report['loss']:.5f}, "
          f"mesh={report['mesh']} ({report['layout']}), "
          f"depth=enc{args.enc_layers}+dec{args.dec_layers}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
