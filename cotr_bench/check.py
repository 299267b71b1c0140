"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``cotr_bench.reference``), after the window.

Serving cells (the numbers are widest gaps):

* ``seed_gap``: the dense seed fields the program computed for the
  request's canvases (flow in the other image's [-1, 1] coordinates and the
  cycle error), against the reference's fields of canvases it builds again
  from the raw images;
* ``refine_gap_px``: each checked device call of the refinement, in pixels
  of the target image: the program's predictions for a crop pair against
  the reference's for the same boxes, its own crops of the raw images and
  the same query points; and each final answer the call returned against
  the reference's last step mapped back to pixels.

The refinement is followed step by step from the program's own state (the
boxes of a squad, the positions a level starts from): a float32 rounding
that moves a box by a pixel would otherwise send the two paths apart. The
start of that chain is checked by ``seed_gap``. The requests checked are
those the driver kept (``ServeDriver.checked``): the slowest of the window
whole at its last level (every answer), two drawn from the seed at a sample
of rows of every level.

The training cell follows the reference's own first steps from the same
weights, batches and dropout generator: ``loss_gap`` (each step's loss,
relative), ``grad_gap`` (the first gradient's norm by the worst leaf) and
``change_gap`` (the norm of each leaf's change over the checked steps, by
the worst leaf), both against the reference's norm of that leaf or of the
median leaf, whichever is larger. Leaves whose reference gradient is under
a thousandth of the median leaf's move under Adam by round-off alone and
are left out of ``change_gap``.

``under_test`` puts another model in the program's place: the control of
the comparison, the reference at a lower precision.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from cotr_bench import pairs as gen
from cotr_bench.reference import crops as rc
from cotr_bench.reference import weights as rw
from cotr_bench.reference.model import QUANT, PlainCOTR, normalize
from cotr_bench.reference.train import run_steps

ROWS_A_LEVEL = 24
ROW_CHUNK = 48
SEED_CANVASES = 2
MATCH_PX = 0.05


@contextlib.contextmanager
def tf32(enabled: bool):
    """Both TF32 switches set for the body, restored after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before


def reference_weights(ctx) -> Dict[str, torch.Tensor]:
    return rw.to_device(rw.read_npz(str(ctx.weights_path)), ctx.device)


def plain_model(ctx, w, precision: Optional[str] = None) -> PlainCOTR:
    s = ctx.sizes
    return PlainCOTR(w, quant=QUANT.get(precision),
                     enc_layers=s["enc_layers"], dec_layers=s["dec_layers"])


# ------------------------------------------------------------------ serving

class Gaps:
    """Gaps gathered over the checked sites; a site that cannot be read
    (a missing field, an answer that never came) is an infinite gap."""

    def __init__(self):
        self.parts = []

    def add(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if len(v):
            self.parts.append(v)

    def missing(self) -> None:
        self.parts.append(np.array([np.inf]))

    def stats(self, name: str) -> dict:
        v = np.concatenate(self.parts) if self.parts else np.array([np.inf])
        finite = v[np.isfinite(v)]
        p99 = float(np.quantile(finite, 0.99)) if len(finite) == len(v) \
            else float("inf")
        mean = float(finite.mean()) if len(finite) == len(v) \
            else float("inf")
        return {name: float(v.max()), f"{name}_p99": p99,
                f"{name}_mean": mean}


def _seed_gaps(driver, rec, ref, under_test, rng, gaps: Gaps) -> None:
    canvases = torch.cat([rc.seed_canvases(a, b)
                          for a, b in driver.dense_pairs(rec)], 0)
    prog = torch.cat(rec["dense"], 0) if rec["dense"] else None
    if prog is None or prog.shape[0] != canvases.shape[0]:
        gaps.missing()
        return
    stride = int(driver.traffic["engine"].get("seed_stride", 1))
    for j in rng.choice(len(canvases), min(SEED_CANVASES, len(canvases)),
                        replace=False):
        want = rc.dense_field(ref, canvases[j:j + 1], stride)
        got = prog[j:j + 1].float() if under_test is None else \
            rc.dense_field(under_test, canvases[j:j + 1], stride)
        gaps.add((got - want).abs().cpu().numpy())


def _image01(img_u8: torch.Tensor) -> torch.Tensor:
    return img_u8.float() / 255.0


def _squad_rows(rec) -> List[tuple]:
    """(dispatch, row, pair position, final level?) of every real squad
    row of the request; padding rows have no member."""
    rows, min_size = [], {}
    for d, (idx, _, bt, q, _) in enumerate(rec["dispatch"]):
        q = np.asarray(q)
        for r in np.nonzero(np.abs(q).sum(axis=(1, 2)) > 0)[0]:
            p = 0 if idx is None else int(np.asarray(idx)[r])
            size = float(np.asarray(bt)[r, 2])
            min_size[p] = min(min_size.get(p, size), size)
            rows.append((d, int(r), p, size))
    return [(d, r, p, size == min_size[p]) for d, r, p, size in rows]


def squad_gaps(driver, rec, ref, under_test, rng, whole: bool,
                gaps: Gaps) -> None:
    rows = _squad_rows(rec)
    if not rows:
        gaps.missing()
        return
    final = [x for x in rows if x[3]]
    pick = rng.choice(len(rows), min(ROWS_A_LEVEL * len(driver.zooms),
                                     len(rows)), replace=False)
    chosen = [rows[i] for i in pick]
    if whole:
        chosen += final
    else:
        chosen += [final[i] for i in rng.choice(
            len(final), min(ROWS_A_LEVEL, len(final)), replace=False)]
    for start in range(0, len(chosen), ROW_CHUNK):
        _squad_chunk(driver, rec, chosen[start:start + ROW_CHUNK], ref,
                     under_test, gaps)


def _squad_chunk(driver, rec, chunk, ref, under_test, gaps: Gaps) -> None:
    canvases, members = [], []
    width = max(np.asarray(rec["dispatch"][d][3]).shape[1]
                for d, _, _, _ in chunk)
    queries = np.zeros((len(chunk), width, 2), np.float32)
    for k, (d, r, p, _) in enumerate(chunk):
        _, bf, bt, q, _ = rec["dispatch"][d]
        pair = driver.pool[rec["pairs"][p]]
        canvases.append(torch.cat([rc.crop(_image01(pair.dev_a), bf[r]),
                                   rc.crop(_image01(pair.dev_b), bt[r])], 1))
        qr = np.asarray(q[r], np.float32)
        members.append(np.nonzero(np.abs(qr).sum(1) > 0)[0])
        queries[k, :len(qr)] = qr
    dev = canvases[0].device
    canvas = normalize(torch.stack(canvases))
    qt = torch.from_numpy(queries).to(dev)
    want = ref(canvas, qt).double().cpu().numpy()
    other = None if under_test is None else \
        under_test(canvas, qt).double().cpu().numpy()
    for k, (d, r, p, final) in enumerate(chunk):
        _, bf, bt, _, out = rec["dispatch"][d]
        m = members[k]
        got = out[r].double().cpu().numpy()[m] if other is None \
            else other[k, m]
        w = want[k, m]
        st = float(bt[r, 2])
        diff = (got - w) * np.array([2 * st, st])
        gaps.add(np.hypot(diff[:, 0], diff[:, 1]))
        if final:
            _answer_gaps(driver, rec, p, bf[r], bt[r], queries[k][m], w,
                         got, other is not None, gaps)


def _answer_gaps(driver, rec, p, bf, bt, q, want, got, control,
                 gaps: Gaps) -> None:
    """The final answers of a last-level squad against the reference's
    prediction mapped back to pixels."""
    pair = driver.pool[rec["pairs"][p]]
    sf, st = float(bf[2]), float(bt[2])
    loc_from = np.stack([q[:, 0] * 2 * sf + bf[0], q[:, 1] * sf + bf[1]], 1)

    def to_px(pred):
        return np.stack([(pred[:, 0] - 0.5) * 2 * st + bt[0],
                         pred[:, 1] * st + bt[1]], 1)

    ref_px = to_px(want)
    if control:
        gaps.add(np.linalg.norm(to_px(got) - ref_px, axis=1))
        return
    out = rec["out"][p]
    for i, lf in enumerate(loc_from):
        dist = np.linalg.norm(pair.queries - lf, axis=1)
        qi = int(dist.argmin())
        if dist[qi] > MATCH_PX or qi >= len(out) \
                or not np.array_equal(out[qi, :2], pair.queries[qi]):
            gaps.missing()
            continue
        gaps.add([np.linalg.norm(out[qi, 2:] - ref_px[i])])


def _patch_box(pos: torch.Tensor, scale: torch.Tensor, h: int, w: int):
    """Square box of side 2 * floor(short * scale / 2) centred at ``pos``
    and moved inside the image, in float32."""
    short = torch.tensor(float(min(h, w)), dtype=torch.float32)
    size = torch.floor(short * torch.clamp(scale, 0.0, 1.0) / 2.0) * 2.0
    half = torch.floor(size / 2.0)
    x = torch.minimum(torch.clamp(torch.floor(pos[:, 0] - half), min=0.0),
                      float(w) - size)
    y = torch.minimum(torch.clamp(torch.floor(pos[:, 1] - half), min=0.0),
                      float(h) - size)
    return x, y, size


def scan_gaps(driver, rec, ref, under_test, rng, whole: bool,
               gaps: Gaps) -> None:
    calls = rec["refine"]
    if not calls:
        gaps.missing()
        return
    out = rec["out"][0]
    pair = driver.pool[rec["pairs"][0]]
    # the returned rows are forward tasks: (loc_from, last level)
    where = {}
    for c, call in enumerate(calls):
        if call["forward"]:
            for t, lf in enumerate(call["loc_from"]):
                where.setdefault(tuple(lf), (c, t))
    todo: Dict[int, set] = {}
    answers = {}
    rows = range(len(out)) if whole else rng.choice(
        len(out), min(ROWS_A_LEVEL, len(out)), replace=False)
    for i in rows:
        hit = where.get(tuple(out[i, :2]))
        if hit is None:
            gaps.missing()
            continue
        todo.setdefault(hit[0], set()).add(hit[1])
        answers[hit] = out[i, 2:]
    for c in rng.choice(len(calls), min(2, len(calls)), replace=False):
        n = len(calls[c]["loc_from"])
        todo.setdefault(int(c), set()).update(
            int(t) for t in rng.choice(n, min(ROWS_A_LEVEL, n),
                                       replace=False))
    for c, tasks in todo.items():
        call = calls[c]
        src, dst = (pair.dev_a, pair.dev_b) if call["forward"] else \
            (pair.dev_b, pair.dev_a)
        t_idx = np.array(sorted(tasks))
        for start in range(0, len(t_idx), ROW_CHUNK):
            _scan_chunk(call, t_idx[start:start + ROW_CHUNK], src, dst, ref,
                        under_test, answers, c, gaps)


def _scan_chunk(call, tasks, src, dst, ref, under_test, answers, c,
                gaps: Gaps) -> None:
    hist = np.asarray(call["history"])
    lf = torch.from_numpy(call["loc_from"][tasks]).float()
    h_a, w_a = src.shape[:2]
    h_b, w_b = dst.shape[:2]
    zooms = np.asarray(call["zooms"], np.float32)
    s_from = torch.tensor(call["s_from"], dtype=torch.float32)
    s_to = torch.tensor(call["s_to"], dtype=torch.float32)
    for z, zoom in enumerate(zooms):
        prev = call["loc_to0"][tasks] if z == 0 else hist[z - 1][tasks]
        prev = torch.from_numpy(np.asarray(prev)).float()
        zt = torch.tensor(zoom, dtype=torch.float32)
        x0f, y0f, sf = _patch_box(lf, s_from * zt, h_a, w_a)
        x0t, y0t, st = _patch_box(prev, s_to * zt, h_b, w_b)
        q = torch.stack([(lf[:, 0] - x0f) / (2.0 * sf),
                         (lf[:, 1] - y0f) / sf], -1)[:, None, :]
        canv = []
        for k in range(len(tasks)):
            bf = (float(x0f[k]), float(y0f[k]), float(sf), float(sf))
            bt = (float(x0t[k]), float(y0t[k]), float(st), float(st))
            canv.append(torch.cat([rc.crop(_image01(src), bf),
                                   rc.crop(_image01(dst), bt)], 1))
        canvas = normalize(torch.stack(canv))
        q = q.to(src.device)

        def to_px(pred):
            p = pred[:, 0, :].double().cpu()
            nx = (p[:, 0] - 0.5) * 2.0 * float(st) + x0t.double()
            ny = p[:, 1] * float(st) + y0t.double()
            return torch.stack([nx, ny], -1).float().double().numpy()

        want = to_px(ref(canvas, q))
        got = hist[z][tasks].astype(np.float64) if under_test is None \
            else to_px(under_test(canvas, q))
        gaps.add(np.linalg.norm(got - want, axis=1))
        if z == len(zooms) - 1 and call["forward"]:
            for k, t in enumerate(tasks):
                ans = answers.get((c, int(t)))
                if ans is not None:
                    got_a = ans if under_test is None else got[k]
                    gaps.add([np.linalg.norm(got_a - want[k])])


def serve_numbers(driver, under_test: Optional[str] = None) -> dict:
    """The serving cell's numbers over the requests the driver kept for
    the comparison (``driver.checked()``); ``under_test`` names a lower
    precision ("tf32", "fp8") whose reference takes the program's place.
    The entry's ``site`` compares its refinement."""
    ctx = driver.ctx
    checked = driver.checked()
    seed, refine = Gaps(), Gaps()
    if not checked:
        seed.missing()
        refine.missing()
        return {**seed.stats("seed_gap"), **refine.stats("refine_gap_px")}
    rng = gen.rng_for(ctx.seed, 5)
    w = reference_weights(ctx)
    ref = plain_model(ctx, w)
    other = None if under_test is None else plain_model(ctx, w, under_test)
    with torch.no_grad(), tf32(False):
        for rec, whole in checked:
            _seed_gaps(driver, rec, ref, other, rng, seed)
            driver.site(driver, rec, ref, other, rng, whole, refine)
    return {**seed.stats("seed_gap"), **refine.stats("refine_gap_px")}


# ----------------------------------------------------------------- training

def port_key(name: str) -> str:
    """A parameter's dotted name in the port -> its Flax path."""
    parts = name.split(".")
    if parts[-1] == "weight":
        norm = parts[-2].startswith("norm") or parts[-2] == "decoder_norm"
        parts[-1] = "scale" if norm else "kernel"
    return "/".join(parts)


def _leaf_gaps(got: dict, want: dict, keys) -> np.ndarray:
    """Each leaf's |norm(got) - norm(want)| over the larger of the leaf's
    reference norm and the median leaf's (infinite where a leaf is
    missing)."""
    norms = {k: float(want[k].double().norm()) for k in keys}
    median = float(np.median(list(norms.values())))
    return np.array([abs(float(got[k].double().norm()) - norms[k])
                     / max(norms[k], median, 1e-30) if k in got
                     else np.inf for k in keys])


def train_numbers(driver, under_test: Optional[str] = None) -> dict:
    ctx = driver.ctx
    steps = len(driver.losses)
    w = reference_weights(ctx)
    layers = (ctx.sizes["enc_layers"], ctx.sizes["dec_layers"])
    dropout = float(ctx.config["model"]["dropout"])
    lr = driver.train_cfg.learning_rate
    batches = driver.batches[:steps]
    with tf32(False):
        ref = run_steps(w, batches, driver.gen_seed, lr, dropout,
                        layers=layers)
    if under_test is None:
        losses = [float(v) for v in driver.losses]
        grad = {port_key(n): g for n, g in driver.grad1.items()}
        change = {port_key(n): driver.p_checked[n] - driver.p0[n]
                  for n in driver.p0}
    else:
        with tf32(True):
            other = run_steps(w, batches, driver.gen_seed, lr, dropout,
                              quant=QUANT[under_test], layers=layers)
        losses = other["loss"]
        grad = other["grad"]
        change = {k: other["params"][k] - w[k] for k in other["params"]}
    ref_change = {k: ref["params"][k] - w[k] for k in ref["params"]}
    keys = sorted(ref["grad"])
    gnorm = {k: float(ref["grad"][k].double().norm()) for k in keys}
    median = float(np.median(list(gnorm.values())))
    moving = [k for k in keys if gnorm[k] >= 1e-3 * median]
    loss = np.array([abs(a - b) / max(abs(b), 1e-30)
                     for a, b in zip(losses, ref["loss"])])
    if len(losses) != len(ref["loss"]) or not np.isfinite(losses).all():
        loss = np.full(len(ref["loss"]), np.inf)
    g = _leaf_gaps(grad, ref["grad"], keys)
    c = _leaf_gaps(change, ref_change, moving)
    return {"loss_gap": float(loss.max()), "loss1_gap": float(loss[0]),
            "grad_gap": float(g.max()), "grad_gap_median": float(np.median(g)),
            "change_gap": float(c.max()),
            "change_gap_median": float(np.median(c)),
            "left_out": len(keys) - len(moving)}
