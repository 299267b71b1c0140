"""What every cell's driver shares, and the loaders of the code a traffic
file names.

A traffic file (``traffic/<mix>.json``) is data: sizes, counts, ranges
and the engine's options. Two of its keys name code, each a file found by
that name as a metric's reader is:

* ``entry``: ``entries/<entry>.py`` defines ``Driver``, which builds the
  program at one of its public entry points, makes the cell's inputs and
  sends one request at a time (``request(i)``);
* ``loop``: ``loops/<loop>.py`` defines ``window(driver, seconds, sync)``,
  the arrival pattern of the measured window.

A later cell at a new entry point or under a new arrival pattern is a new
file and an entry naming it, and edits no file that is there.

A serving driver (``ServeDriver``) cycles a pool of generated pairs, a
call at a time. With ``pool_seed`` in the traffic the pool, and each
pair's engine seed, are made from that fixed seed and ``--seed`` chooses
only the order of the calls, so that every seed sends the same work.
While a request runs, the driver keeps what the comparison with the
reference needs, and after it only for the requests that the comparison
checks: two drawn from the seed among the window's first three, and the
slowest of the rest.
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from cotr_bench import pairs as gen

EXTRA_CHECKED = 2
EXTRA_FROM = 3


def load_code(root: Path, folder: str, name: str):
    """``cotr_bench/<folder>/<name>.py`` under ``root``, as a module."""
    path = Path(root) / "cotr_bench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder} file {path}")
    mod_name = f"cotr_bench_{folder}_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def make(ctx: "Context"):
    """The driver of the entry that the cell's traffic names."""
    return load_code(ctx.root, "entries", ctx.traffic["entry"]).Driver(ctx)


def window_of(ctx: "Context"):
    """The window function of the loop that the cell's traffic names."""
    return load_code(ctx.root, "loops", ctx.traffic["loop"]).window


def zoom_ins(traffic: dict) -> List[float]:
    lo, hi, n = traffic["zoom_linspace"]
    return [float(z) for z in np.linspace(lo, hi, int(n))]


def model_sizes(config: dict) -> dict:
    """The sizes the yardstick's arithmetic reads, from the config's
    ``model`` block (COTRConfig's fields)."""
    m = config["model"]
    channels = {"layer1": 256, "layer2": 512, "layer3": 1024,
                "layer4": 2048}[m["layer"]]
    return dict(layer=m["layer"], hidden_dim=m["hidden_dim"],
                nheads=m["nheads"], enc_layers=m["enc_layers"],
                dec_layers=m["dec_layers"], backbone_channels=channels,
                ffn_dim=channels, dtype=m["dtype"])


class Context:
    """What a driver is given: the checkout's root, the cell's files, the
    seed, the device and whether the window is traced."""

    def __init__(self, root: Path, config: dict, traffic: dict, seed: int,
                 device: str, traced: bool = False):
        self.root = Path(root)
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.traced = bool(traced)
        self.sizes = model_sizes(config)

    @property
    def weights_path(self) -> Path:
        return self.root / self.config["weights"]


def program_model(ctx: Context):
    from cotr_tpu_torch.config import COTRConfig
    from cotr_tpu_torch.models.checkpoint_io import load_model

    cfg = COTRConfig(**ctx.config["model"])
    return load_model(str(ctx.weights_path), cfg, device=ctx.device)


class Spans:
    """Host seconds by span name, for the per-layer readers."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    def add(self, name: str, sec: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + sec


class ServeDriver:
    """Common part of the serving entries. A subclass sets ``make_engine``,
    ``call``, ``dense_pairs``, ``site`` (the comparison of its refinement,
    from ``cotr_bench.check``) and, where it has more than one pair a call,
    ``pairs_per_call``."""

    kind = "serve"
    pairs_per_call = 1
    program_state = ("engine", "runner")

    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.traffic = ctx.traffic
        self.spans = Spans()
        self.outs: List[tuple] = []
        self.slowest = None
        self.extra: Dict[int, dict] = {}
        self.current = None
        self.closed = False
        self.zooms = zoom_ins(self.traffic)

    # --------------------------------------------------------------- set-up
    def build(self) -> None:
        from cotr_tpu_torch.inference.runner import ModelRunner

        self.runner = ModelRunner(program_model(self.ctx),
                                  device=self.ctx.device)
        t = self.traffic
        pool_seed = int(t.get("pool_seed", self.ctx.seed))
        self.pool = [gen.make_pair(pool_seed, i, t["image_hw"], t,
                                   self.ctx.device)
                     for i in range(int(t["pool"]))]
        rng = gen.rng_for(pool_seed, 3)
        self.engine_seed = int(rng.integers(0, 2 ** 31 - 1))
        self.pair_seeds = [int(s) for s in
                           rng.integers(0, 2 ** 31 - 1, len(self.pool))]
        self.order = gen.call_order(self.ctx.seed, self.calls_per_pass())
        self.extra_at = set(int(i) for i in gen.rng_for(
            self.ctx.seed, 7).choice(EXTRA_FROM, EXTRA_CHECKED,
                                     replace=False))
        self.engine = self.make_engine()
        self._install()

    def _install(self) -> None:
        import cotr_tpu_torch.inference.dense as dense_mod

        # one wrapper a process, over the program's own function
        orig_pass = getattr(dense_mod, "_bench_original",
                            dense_mod.dense_pass_device)
        dense_mod._bench_original = orig_pass

        def recorded_pass(runner, canvas, stride=1):
            out = orig_pass(runner, canvas, stride)
            if self.current is not None:
                self.current["dense"].append(out)
            return out

        dense_mod.dense_pass_device = recorded_pass
        if not self.ctx.traced:
            return
        orig_fields = self.engine._dense_fields_many

        def seed_span(pair_list):
            t0 = time.perf_counter()
            with torch.profiler.record_function("cotr_bench.seed"):
                out = orig_fields(pair_list)
                if self.ctx.device != "cpu":
                    torch.cuda.synchronize()
            self.spans.add("seed", time.perf_counter() - t0)
            return out

        self.engine._dense_fields_many = seed_span

    def warm_up(self, sync) -> int:
        """The window's first call again until the attention wrapper's
        shapes stop growing; returns the passes taken."""
        from cotr_tpu_torch.ops import attention

        seen = None
        for passes in range(1, 4):
            self.request(0, keep=False)
            sync()
            shapes = set(attention.shape_counts)
            if shapes == seen:
                return passes
            seen = shapes
        return passes

    def counters(self) -> dict:
        stepper = getattr(self.engine, "_stepper", None)
        if stepper is None:
            return {}
        return {"canvases": stepper.canvas_count}

    # ------------------------------------------------------------- requests
    def calls_per_pass(self) -> int:
        return len(self.pool) // self.pairs_per_call

    def pairs_of(self, i: int) -> List[int]:
        k = self.pairs_per_call
        start = int(self.order[i % self.calls_per_pass()]) * k
        return list(range(start, start + k))

    def request(self, i: int, keep: bool = True) -> int:
        """Request ``i`` of the window (the pool's calls cycled in this
        seed's order); returns the number of correspondences returned."""
        idx = self.pairs_of(i)
        rec = {"index": i, "pairs": idx, "dense": [], "dispatch": [],
               "refine": []}
        self.current = rec if keep and not self.closed else None
        t0 = time.perf_counter()
        try:
            rec["out"] = self.call([self.pool[j] for j in idx],
                                   [self.pair_seeds[j] for j in idx])
        finally:
            self.current = None
        rec["wall_s"] = time.perf_counter() - t0
        if keep:
            self._keep(rec)
        return sum(len(o) for o in rec["out"])

    def _keep(self, rec: dict) -> None:
        self.outs.append((rec["pairs"], rec["out"]))
        if self.closed:
            return
        if rec["index"] in self.extra_at:
            self.extra[rec["index"]] = rec
        elif self.slowest is None or rec["wall_s"] > self.slowest["wall_s"]:
            self.slowest = rec

    def checked(self) -> List[tuple]:
        """(record, whole?) of each request the comparison checks: the
        slowest of those not drawn is checked whole."""
        out = [] if self.slowest is None else [(self.slowest, True)]
        return out + [(self.extra[i], False) for i in sorted(self.extra)]

    def after_window(self) -> dict:
        """The answers to one pass of the pool (calls run after the window
        where it held less than a pass), their pixel errors against the
        known homographies, and the requests whose answers were not
        finite."""
        self.closed = True
        failed = sum(int(not np.isfinite(np.concatenate(
            [o.ravel() for o in out])).all()) for _, out in self.outs)
        passes = self.calls_per_pass()
        for i in range(len(self.outs), passes):
            self.request(i)
        errs = [self.pixel_errors(p, out) for p, out in self.outs[:passes]]
        return {"failed": failed, "pool_errors": np.concatenate(errs)}

    def pixel_errors(self, pair_idx, outs) -> np.ndarray:
        errs = []
        for j, corrs in zip(pair_idx, outs):
            truth = gen.apply_h(self.pool[j].hmat, corrs[:, :2])
            errs.append(np.linalg.norm(corrs[:, 2:] - truth, axis=1))
        return np.concatenate(errs)

    def free(self) -> None:
        """The program's state goes before the reference runs."""
        for attr in self.program_state:
            if hasattr(self, attr):
                delattr(self, attr)

    def numbers(self, under_test=None) -> dict:
        from cotr_bench import check

        return check.serve_numbers(self, under_test)
