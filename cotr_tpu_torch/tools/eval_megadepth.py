"""MegaDepth validation sweep (counterpart of eval_megadepth.py): dense
correspondence end-point error against geometric ground truth.

For the validation split's pairs: the ground-truth flow lifts the
neighbour's depth to world points and projects them into the query camera
(``geometry.projector.optical_flow_from_a_to_b(query, neighbour)``), which
gives, for each query pixel, the neighbour's pixel that sees the same
point; the engine answers a
dense query grid at the requested zoom depth, a ``--pair_batch`` of pairs a
call; the errors over the queries with valid ground truth give the EPE
mean and median and the PCK at 1, 3 and 5 px.

  python -m cotr_tpu_torch.tools.eval_megadepth --dataset_config md.json \\
      --load_weights_path checkpoints/flagship.npz --pairs 10 --grid 64

The flags and defaults are the JAX script's. The JAX script reads the flow
the other way round (``optical_flow_from_a_to_b(neighbour, query)``: for
each neighbour pixel the query's) at the query grid, so its ground truth is
about the inverse displacement and its EPE about twice the displacement
between the views; here the ground truth is the query's. The engine is the
demos' (``demos.demo_utils.build_engine``), as in the JAX script:
``FasterSparseEngine(mode="stretching")``, or ``SparseEngine`` with
``--faster_infer no``, over the weights of ``--load_weights_path`` (any
file ``load_params`` reads; random weights from seed 0 without one). It
runs on the card; ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.demos.demo_utils import build_engine


def prepare_pair(query_cap, nn_cap, grid: int):
    """Images, dense query grid, and ground-truth flow for one validation
    pair, or None when fewer than 10 queries have ground truth. The grid
    spans the query image; ``gt[i]`` is the neighbour's pixel that sees
    query ``i``'s point (0 where no neighbour depth lands there)."""
    from cotr_tpu_torch.geometry.projector import optical_flow_from_a_to_b

    img_a = query_cap.image
    img_b = nn_cap.image
    h, w = img_a.shape[:2]

    gt_flow = optical_flow_from_a_to_b(query_cap, nn_cap)
    ys = np.linspace(8, h - 9, grid).astype(int)
    xs = np.linspace(8, w - 9, grid).astype(int)
    gx, gy = np.meshgrid(xs, ys)
    queries = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)

    gt = gt_flow[gy.ravel(), gx.ravel()]
    valid = (np.abs(gt).sum(axis=1) > 0)
    if valid.sum() < 10:
        return None
    return img_a, img_b, queries, gt, valid


def _epe_from_corrs(queries, gt, valid, corrs, idx):
    pred = np.full((len(queries), 2), np.nan)
    pred[idx] = corrs[:, 2:]
    ok = valid & np.isfinite(pred).all(axis=1)
    return np.linalg.norm(pred[ok] - gt[ok], axis=1)


def evaluate_batch(engine, prepped, zoom_ins):
    """One multi-pair engine call over the prepared pairs (serial calls for
    an engine without the multi-pair entry point); the EPE of each pair's
    queries with ground truth."""
    if hasattr(engine, "cotr_corr_multiscale_multipair"):
        results = engine.cotr_corr_multiscale_multipair(
            [(p[0], p[1]) for p in prepped], zoom_ins=zoom_ins,
            converge_iters=1,
            max_corrs=[len(p[2]) for p in prepped],
            queries_list=[p[2] for p in prepped], force=True,
            return_idx=True)
    else:
        results = [engine.cotr_corr_multiscale(
            p[0], p[1], zoom_ins=zoom_ins, converge_iters=1,
            max_corrs=len(p[2]), queries_a=p[2], force=True,
            return_idx=True) for p in prepped]
    return [_epe_from_corrs(p[2], p[3], p[4], corrs, idx)
            for p, (corrs, idx) in zip(prepped, results)]


def summarize(all_epe, seconds: float) -> dict:
    """EPE mean and median, PCK at 1/3/5 px over every query of every
    pair, the pair and query counts and the wall time."""
    epe = np.concatenate(all_epe) if all_epe else np.array([np.nan])
    return {
        "epe_mean": float(np.mean(epe)),
        "epe_median": float(np.median(epe)),
        "pck_1px": float((epe < 1).mean()),
        "pck_3px": float((epe < 3).mean()),
        "pck_5px": float((epe < 5).mean()),
        "pairs": len(all_epe),
        "queries": int(epe.size),
        "wall_s": round(seconds, 1),
    }


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset_config", required=True)
    ap.add_argument("--load_weights_path", default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--grid", type=int, default=64,
                    help="dense grid side (grid^2 queries per pair)")
    ap.add_argument("--zoom_depth", type=int, default=3)
    ap.add_argument("--faster_infer", default="yes")
    ap.add_argument("--batch_size", type=int, default=1024)
    ap.add_argument("--pair_batch", type=int, default=8,
                    help="image pairs refined per multi-pair engine call "
                         "(pairs share device dispatches)")
    ap.add_argument("--max_corrs", type=int, default=100000)
    ap.add_argument("--out", default="eval_megadepth.json")
    return ap.parse_args(argv)


def data_config(dataset_config: str):
    """The validation split of ``dataset_config`` on full frames."""
    from cotr_tpu_torch.data.megadepth import DataConfig

    with open(dataset_config) as f:
        raw = json.load(f)
    return DataConfig(
        scenes_name_list=raw["scenes_name_list"],
        valid_list_json=raw["valid_list_json"],
        train_json=raw["train_json"], val_json=raw["val_json"],
        test_json=raw.get("test_json", raw["val_json"]),
        crop_cam="no_crop")


def evaluate(engine, ds, n_pairs: int, grid: int, zoom_ins,
             pair_batch: int):
    """The sweep over the dataset's first ``n_pairs`` queries, a
    ``pair_batch`` of prepared pairs at a time: (the summary, each
    evaluated pair's EPE array). Pair numbers printed are the dataset's (a
    skipped pair keeps its number)."""
    all_epe = []
    t0 = time.time()
    chunk, chunk_idx = [], []

    def flush():
        for j, epe in enumerate(evaluate_batch(engine, chunk, zoom_ins)):
            all_epe.append(epe)
            print(f"pair {chunk_idx[j]}: {len(epe)} valid, "
                  f"EPE mean {epe.mean():.2f} median {np.median(epe):.2f}")
        chunk.clear()
        chunk_idx.clear()

    for i in range(min(n_pairs, ds.num_queries)):
        query_cap, nn_caps = ds.get_query_with_knn(i)
        p = prepare_pair(query_cap, nn_caps[0], grid)
        if p is None:
            continue
        chunk.append(p)
        chunk_idx.append(i)
        if len(chunk) == pair_batch:
            flush()
    if chunk:
        flush()
    return summarize(all_epe, time.time() - t0), all_epe


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    from cotr_tpu_torch.data.megadepth import MegadepthDataset
    from cotr_tpu_torch.utils.constants import zoom_ladder

    args = parse_args(argv)
    ds = MegadepthDataset(data_config(args.dataset_config), "val")
    engine = build_engine(args, mode="stretching", device=device)
    result, _ = evaluate(engine, ds, args.pairs, args.grid,
                         zoom_ladder(args.zoom_depth), args.pair_batch)
    print(json.dumps(result, indent=2))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
