"""SparseEngine and FasterSparseEngine: the sparse correspondence API
(counterpart of cotr_tpu/inference/engine.py).

Same seeding rules, thresholds, filters and return conventions as the JAX
engine: seeding is vectorized numpy over the dense-pass fields, and
refinement advances all tasks through the zoom schedule in lockstep
(inference/refine.py). Host randomness is ``np.random.RandomState(seed)``,
so both packages draw the same seeds.

``FasterSparseEngine`` refines through the squad machinery of
inference/grouped.py instead, where queries that fall inside a pilot's patch
window share the pilot's canvas encode, and adds the multi-pair entry
points, which put the squads of many image pairs into shared device calls.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cotr_tpu_torch.inference.dense import (_canvases_for_jobs,
                                            dense_flow_many,
                                            to_square_patches)
from cotr_tpu_torch.inference.grouped import (GroupedStepper,
                                              refine_grouped,
                                              refine_grouped_pairs)
from cotr_tpu_torch.inference.refine import BatchRefiner
from cotr_tpu_torch.inference.runner import ModelRunner
from cotr_tpu_torch.ops.sampling import resize_pil_host
from cotr_tpu_torch.utils.constants import (BASE_ZOOM, MAX_SIZE,
                                            THRESHOLD_AREA,
                                            THRESHOLD_PIXELS_RELATIVE,
                                            THRESHOLD_SPARSE)


def relative_scales(area_a: float, area_b: float) -> Tuple[float, float]:
    """(s_from, s_to) from confident-area estimates; zero areas (no
    confident pixels) fall back to equal scales."""
    if area_a <= 0 or area_b <= 0:
        return BASE_ZOOM, BASE_ZOOM
    if area_a < area_b:
        return BASE_ZOOM, BASE_ZOOM * float(np.sqrt(area_b / area_a))
    return BASE_ZOOM * float(np.sqrt(area_a / area_b)), BASE_ZOOM


def stretch_to_square(img: np.ndarray) -> np.ndarray:
    """Stretch to a max(h, w) square with PIL's BILINEAR filter."""
    size = max(img.shape[:2])
    if img.dtype != np.uint8:
        img = np.asarray(img, np.float32)
    return resize_pil_host(img, (size, size))


def _resize_field(field: np.ndarray, shape_hw: Tuple[int, int]
                  ) -> np.ndarray:
    return resize_pil_host(np.asarray(field, np.float32), shape_hw)


class SparseEngine:
    """Parameters
    ----------
    runner: ModelRunner wrapping the model; the engine runs on its device.
    batch_size: tasks refined per device dispatch (a memory bound: each
        task is one canvas through the whole model).
    mode: 'stretching' (non-square images stretched square for the seed
        pass) or 'tile' (patch tiling).
    seed: seed of the confidence-masked random seeding.
    crop_dtype: dtype of the crop matrix products; by default the model's
        compute dtype.
    seed_stride: dense seed-pass grid stride (1 = the full 131k-query grid).
    """

    def __init__(self, runner: ModelRunner, batch_size: int = 256,
                 mode: str = "stretching", seed: int = 0, crop_dtype=None,
                 seed_stride: int = 1):
        if mode not in ("stretching", "tile"):
            raise ValueError(f"mode must be 'stretching' or 'tile', got "
                             f"{mode!r}")
        if seed_stride < 1 or MAX_SIZE % seed_stride:
            raise ValueError(
                f"seed_stride must divide the {MAX_SIZE}-px canvas half, "
                f"got {seed_stride}")
        self.seed_stride = seed_stride
        self.runner = runner
        self.batch_size = batch_size
        self.mode = mode
        cfg = getattr(runner.model, "cfg", None)
        self.crop_dtype = crop_dtype if crop_dtype is not None else \
            getattr(torch, getattr(cfg, "dtype", "float32"))
        self.refiner = BatchRefiner(runner, crop_dtype=self.crop_dtype)
        self.rng = np.random.RandomState(seed)
        self.total_tasks = 0
        # opt-in diagnostics: when True, each cotr_corr_multiscale call
        # keeps its tasks' full zoom histories and the filters' verdicts in
        # ``last_diag``, so an error tail can be told apart (seed miss, zoom
        # divergence, filter miss)
        self.collect_diagnostics = False
        self.last_diag = None
        # zoom scale of cycle_select's reverse check (None = the schedule's
        # coarsest level); see _cycle_select
        self.cycle_zoom = None

    @classmethod
    def from_config(cls, runner: ModelRunner, cfg, **kw):
        """Build from an InferenceConfig."""
        return cls(runner, batch_size=cfg.batch_size, mode=cfg.mode, **kw)

    # ------------------------------------------------------------------ seed

    def _dense_fields_many(self, pairs):
        """Dense seed passes for many pairs honoring the engine mode, in one
        batched device pass. Returns one (corr_a, con_a, corr_b, con_b) per
        pair at ORIGINAL image resolutions."""
        prepped = []
        for img_a, img_b in pairs:
            a_shape, b_shape = img_a.shape[:2], img_b.shape[:2]
            nonsquare = (a_shape[0] != a_shape[1] or
                         b_shape[0] != b_shape[1])
            if self.mode == "stretching" and nonsquare:
                prepped.append((stretch_to_square(img_a),
                                stretch_to_square(img_b),
                                True, a_shape, b_shape))
            else:
                prepped.append((img_a, img_b, False, a_shape, b_shape))
        raw = dense_flow_many(self.runner,
                              [(a, b) for a, b, _, _, _ in prepped],
                              seed_stride=self.seed_stride)
        out = []
        for (_, _, stretched, a_shape, b_shape), \
                (corr_a, con_a, corr_b, con_b) in zip(prepped, raw):
            if stretched:
                corr_a = _resize_field(corr_a, a_shape)
                con_a = _resize_field(con_a, a_shape)
                corr_b = _resize_field(corr_b, b_shape)
                con_b = _resize_field(con_b, b_shape)
            out.append((corr_a, con_a, corr_b, con_b))
        return out

    def _seed_tasks(self, img_a, img_b, max_corrs, queries_a, force,
                    dense=None, rng=None):
        """Vectorized task generation. Returns (loc_from, loc_to,
        identifiers, area_a, area_b) for a->b refinements. ``dense`` passes
        precomputed seed fields; ``rng`` takes the place of the engine's
        stream (a stream per pair keeps multi-pair runs equal to serial
        ones)."""
        if rng is None:
            rng = self.rng
        corr_a, con_a, corr_b, con_b = dense if dense is not None \
            else self._dense_fields_many([(img_a, img_b)])[0]
        h_a, w_a = img_a.shape[:2]
        h_b, w_b = img_b.shape[:2]
        mask_a = con_a < THRESHOLD_SPARSE
        mask_b = con_b < THRESHOLD_SPARSE
        area_a = float((con_a < THRESHOLD_AREA).sum()) / mask_a.size
        area_b = float((con_b < THRESHOLD_AREA).sum()) / mask_b.size

        def lookup(corr, pos_yx, to_wh):
            tgt = corr[pos_yx[:, 0], pos_yx[:, 1]]  # (N, 2) in [-1, 1]
            return (tgt * 0.5 + 0.5) * np.asarray(to_wh)

        if queries_a is None:
            # random confident seeds from BOTH directions
            idx_a = np.argwhere(mask_a)
            idx_b = np.argwhere(mask_b)
            sel_a = idx_a[rng.choice(len(idx_a),
                                     min(max_corrs, len(idx_a)))] \
                if len(idx_a) else np.zeros((0, 2), int)
            sel_b = idx_b[rng.choice(len(idx_b),
                                     min(max_corrs, len(idx_b)))] \
                if len(idx_b) else np.zeros((0, 2), int)
            lf_a = sel_a[:, ::-1].astype(np.float64)
            lt_a = lookup(corr_a, sel_a, (w_b, h_b))
            # b-seeds fix the first guess instead of the query
            lt_b = sel_b[:, ::-1].astype(np.float64)
            lf_b = lookup(corr_b, sel_b, (w_a, h_a))
            loc_from = np.concatenate([lf_a, lf_b], axis=0)
            loc_to = np.concatenate([lt_a, lt_b], axis=0)
            ident = np.arange(len(loc_from))
        elif force:
            # every query becomes a task
            pos = queries_a[:, ::-1]
            pos = np.stack([np.clip(pos[:, 0], 0, corr_a.shape[0] - 1),
                            np.clip(pos[:, 1], 0, corr_a.shape[1] - 1)],
                           axis=1).astype(int)
            loc_from = queries_a.astype(np.float64)
            loc_to = lookup(corr_a, pos, (w_b, h_b))
            ident = np.arange(len(queries_a))
        else:
            # confidence-filtered, backfilled up to max_corrs
            pos = queries_a[:, ::-1]
            inb = ((pos < np.array([h_a, w_a]) - 1).all(axis=1) &
                   (pos >= 0).all(axis=1))
            posi = np.floor(pos).astype(int)
            posi_c = np.stack([np.clip(posi[:, 0], 0, h_a - 1),
                               np.clip(posi[:, 1], 0, w_a - 1)], axis=1)
            confident = np.zeros(len(queries_a), bool)
            confident[inb] = mask_a[posi_c[inb, 0], posi_c[inb, 1]]
            chosen = inb & confident
            n_backfill = max(0, max_corrs - int(chosen.sum()))
            backfill_pool = np.where(inb & ~confident)[0][:n_backfill]
            sel = np.concatenate([np.where(chosen)[0], backfill_pool])
            loc_from = queries_a[sel].astype(np.float64)
            loc_to = lookup(corr_a, posi_c[sel], (w_b, h_b))
            ident = sel
        return (loc_from, loc_to, ident.astype(int), area_a, area_b)

    # ---------------------------------------------------------------- refine

    def _refine_all(self, img_a, img_b, loc_from, loc_to, area_a, area_b,
                    zoom_ins, converge_iters):
        """Every task through the zoom schedule; returns the location history
        (len(zoom_ins)+1, T, 2): the seed row plus one converged row per zoom
        level."""
        s_from, s_to = relative_scales(area_a, area_b)
        dev_a = self.refiner.prepare_image(img_a)
        dev_b = self.refiner.prepare_image(img_b)
        histories = []
        for start in range(0, len(loc_from), self.batch_size):
            lf = loc_from[start:start + self.batch_size]
            lt = loc_to[start:start + self.batch_size]
            hist = self.refiner.refine(dev_a, dev_b, lf, lt, s_from, s_to,
                                       zoom_ins, converge_iters)
            if np.isnan(hist).any():
                raise ValueError("NaN in refinement predictions")
            histories.append(hist)
            self.total_tasks += hist.shape[0] * hist.shape[1]
        history = np.concatenate(histories, axis=1)  # (Z, T, 2)
        return np.concatenate([loc_to[None], history], axis=0)

    # --------------------------------------------------------------- conclude

    def _cycle_select(self, img_a, img_b, loc_from, history, area_a, area_b,
                      check_zoom):
        """Per-query candidate selection by cycle error: ONE reverse pass
        (b->a) with all C*T history candidates as sources and the a-side
        crop centered at the known query; the candidate that maps back
        closest wins. Returns (selected (T, 2), cycle_err (C, T))."""
        hist = np.asarray(history, np.float64)
        c, t = hist.shape[0], hist.shape[1]
        cands = hist.reshape(c * t, 2)
        back0 = np.tile(np.asarray(loc_from, np.float64), (c, 1))
        rev = self._refine_all(img_b, img_a, cands, back0, area_b, area_a,
                               [float(check_zoom)], 1)
        cyc = np.linalg.norm(rev[-1] - back0, axis=1).reshape(c, t)
        hb, wb = img_b.shape[:2]
        oob = ((hist[..., 0] < 0) | (hist[..., 0] >= wb)
               | (hist[..., 1] < 0) | (hist[..., 1] >= hb))
        # Mirrors a quirk of the JAX engine: when EVERY candidate of a query
        # is out of frame, argmin over all-inf picks row 0 (the seed), an
        # out-of-frame answer, instead of the in-frame final level.
        sel = np.where(oob, np.inf, cyc).argmin(axis=0)
        return hist[sel, np.arange(t)], cyc

    def _filter_mask(self, loc_from, history, img_a_shape, img_b_shape,
                     best=None):
        """std filter + border filter as a boolean keep-mask."""
        if best is None:
            best = history[-1]
        corrs = np.concatenate([loc_from, best], axis=1)
        std = history.std(axis=0).max(axis=1)  # (T,)
        keep = std < THRESHOLD_PIXELS_RELATIVE * max(*img_b_shape)
        hi = np.concatenate([np.asarray(img_a_shape[::-1]),
                             np.asarray(img_b_shape[::-1])])
        keep &= (corrs < hi).all(axis=1) & (corrs > 0).all(axis=1)
        return keep

    def _conclude(self, loc_from, history, ident, img_a_shape, img_b_shape,
                  force, best_override=None):
        best = history[-1] if best_override is None else best_override
        corrs = np.concatenate([loc_from, best], axis=1)
        keep = np.ones(len(corrs), bool)
        if not force:
            keep = self._filter_mask(loc_from, history, img_a_shape,
                                     img_b_shape, best=best)
        return corrs[keep], ident[keep]

    # ------------------------------------------------------------ public API

    def cotr_corr_multiscale(self, img_a, img_b,
                             zoom_ins: Sequence[float] = (1.0,),
                             converge_iters: int = 1, max_corrs: int = 1000,
                             queries_a: Optional[np.ndarray] = None,
                             return_idx: bool = False, force: bool = False,
                             areas: Optional[Sequence[float]] = None,
                             cycle_select=False, _dense=None):
        """Multiscale sparse correspondence a->b. Returns (max_corrs, 4)
        [x_a, y_a, x_b, y_b] (+ query indices with return_idx).

        ``areas``: known relative areas; skips the dense pass and seeds by
        one-shot patch queries (needs ``queries_a`` and ``force``).
        ``cycle_select``: False (reference semantics), True (every query
        takes its history candidate with the least reverse cycle error) or
        "rescue" (only queries the std/border filters flag do).
        ``_dense``: precomputed seed fields."""
        img_a = np.asarray(img_a)
        img_b = np.asarray(img_b)
        if queries_a is not None:
            queries_a = np.asarray(queries_a, np.float64).copy()
        if cycle_select not in (False, True, "rescue"):
            raise ValueError(f"cycle_select must be False, True or "
                             f"'rescue', got {cycle_select!r}")

        if areas is not None:
            if queries_a is None or not force:
                raise ValueError("areas needs queries_a and force=True")
            corr = self.corr_base(img_a, img_b, queries_a)
            loc_from, loc_to = corr[:, :2], corr[:, 2:]
            ident = np.arange(len(corr))
            area_a, area_b = float(areas[0]), float(areas[1])
        else:
            loc_from, loc_to, ident, area_a, area_b = self._seed_tasks(
                img_a, img_b, max_corrs, queries_a, force, dense=_dense)

        if len(loc_from) == 0:
            empty = np.zeros((0, 4))
            return (empty, np.zeros(0, int)) if return_idx else empty

        history = self._refine_all(img_a, img_b, loc_from, loc_to,
                                   area_a, area_b, zoom_ins, converge_iters)
        # Mirrors a quirk of the JAX engine: cycle_zoom = 0 is falsy and so
        # treated as unset (the coarsest level is used instead).
        check = self.cycle_zoom if self.cycle_zoom else zoom_ins[0]
        best_override, cyc = None, None
        if cycle_select == "rescue":
            # keep the converged answer where the filters pass; spend the
            # reverse check only on flagged queries
            healthy = self._filter_mask(loc_from, history,
                                        img_a.shape[:2], img_b.shape[:2])
            flagged = np.nonzero(~healthy)[0]
            best_override = history[-1].copy()
            cyc = np.full((history.shape[0], len(loc_from)), np.nan)
            if len(flagged):
                sel, cyc_sub = self._cycle_select(
                    img_a, img_b, loc_from[flagged], history[:, flagged],
                    area_a, area_b, check)
                best_override[flagged] = sel
                cyc[:, flagged] = cyc_sub
        elif cycle_select:
            best_override, cyc = self._cycle_select(
                img_a, img_b, loc_from, history, area_a, area_b, check)
        corrs, idx = self._conclude(loc_from, history, ident,
                                    img_a.shape[:2], img_b.shape[:2], force,
                                    best_override=best_override)
        if self.collect_diagnostics:
            # what the std/border filters WOULD have kept (a force run skips
            # them, so they are applied again with force=False)
            _, kept = self._conclude(loc_from, history, ident,
                                     img_a.shape[:2], img_b.shape[:2], False)
            self.last_diag = {
                "loc_from": loc_from.copy(), "ident": ident.copy(),
                "history": history.copy(),  # (1 seed + Z levels, T, 2)
                "area_a": area_a, "area_b": area_b,
                "kept_by_filters": np.isin(ident, kept)}
            if cycle_select:
                self.last_diag["cycle_err"] = cyc      # (C, T)
                self.last_diag["selected"] = best_override.copy()
        corrs, idx = corrs[:max_corrs], idx[:max_corrs]
        return (corrs, idx) if return_idx else corrs

    def cotr_corr_multiscale_with_cycle_consistency(
            self, img_a, img_b, zoom_ins: Sequence[float] = (1.0,),
            converge_iters: int = 1, max_corrs: int = 1000,
            queries_a: Optional[np.ndarray] = None, return_idx: bool = False,
            return_cycle_error: bool = False):
        """Bidirectional matching ranked by cycle error. Both directions'
        dense seed passes depend only on the images, so they share one
        batched device pass up front."""
        extraction_rate = 0.3
        temp_max = int(max_corrs / extraction_rate)
        if queries_a is not None:
            temp_max = min(temp_max, queries_a.shape[0])
            queries_a = np.asarray(queries_a, np.float64).copy()
        img_a, img_b = np.asarray(img_a), np.asarray(img_b)
        dense_f, dense_b = self._dense_fields_many([(img_a, img_b),
                                                    (img_b, img_a)])
        corr_f, idx_f = self.cotr_corr_multiscale(
            img_a, img_b, zoom_ins=zoom_ins, converge_iters=converge_iters,
            max_corrs=temp_max, queries_a=queries_a, return_idx=True,
            _dense=dense_f)
        if corr_f.shape[0] == 0:
            raise RuntimeError("forward pass produced no correspondences")
        corr_b, idx_b = self.cotr_corr_multiscale(
            img_b, img_a, zoom_ins=zoom_ins, converge_iters=converge_iters,
            max_corrs=corr_f.shape[0], queries_a=corr_f[:, 2:].copy(),
            return_idx=True, _dense=dense_b)
        if corr_b.shape[0] == 0:
            raise RuntimeError("backward pass produced no correspondences")
        out = _rank_by_cycle_error(corr_f, idx_f, corr_b, idx_b, max_corrs,
                                   return_idx, return_cycle_error)
        return out[0] if len(out) == 1 else out

    # ----------------------------------------------------------- extra paths

    def corr_base(self, img_a, img_b, queries_a) -> np.ndarray:
        """One-shot (no-zoom) sparse queries over exhaustive patch pairs,
        each answer taken from the patch pair with the least cycle error."""
        return self.corr_base_many([(img_a, img_b, queries_a)])[0]

    def corr_base_many(self, jobs) -> list:
        """``corr_base`` over many (img_a, img_b, queries_a) jobs: every
        patch-pair canvas of every job joins one encode batch (8 canvases
        per dispatch), with one forward and one cycle decode.
        Returns one (N_i, 4) corrs array per job."""
        entries = []  # (job_idx, p_i, p_j, qn, in_patch)
        for ji, (img_a, img_b, queries_a) in enumerate(jobs):
            q = np.asarray(queries_a, np.float64)
            patches_b = to_square_patches(np.asarray(img_b))
            for p_i in to_square_patches(np.asarray(img_a)):
                in_patch = ((q[:, 0] >= p_i.x) & (q[:, 1] >= p_i.y) &
                            (q[:, 0] <= p_i.x + p_i.w) &
                            (q[:, 1] <= p_i.y + p_i.h))
                qn = np.stack([(q[:, 0] - p_i.x) / (2 * p_i.w),
                               (q[:, 1] - p_i.y) / p_i.h], axis=1)
                for p_j in patches_b:
                    entries.append((ji, p_i, p_j, qn, in_patch))

        n_max = max(e[3].shape[0] for e in entries)
        q_all = np.zeros((len(entries), n_max, 2), np.float32)
        for k, (_, _, _, qn, _) in enumerate(entries):
            q_all[k, :qn.shape[0]] = qn

        chunk = 8
        outs, cycles = [], []
        for start in range(0, len(entries), chunk):
            sub = entries[start:start + chunk]
            canvas = _canvases_for_jobs(
                self.runner, [(p_i.patch, p_j.patch)
                              for _, p_i, p_j, _, _ in sub])
            mem = self.runner.encode(canvas)
            out = self.runner.decode_chunked(mem, q_all[start:start + chunk])
            cyc = self.runner.decode_chunked(mem, out)
            outs.append(out.cpu().numpy())
            cycles.append(cyc.cpu().numpy())
        out_all = np.concatenate(outs, axis=0)
        cyc_all = np.concatenate(cycles, axis=0)

        per_job = [[] for _ in jobs]
        for k, (ji, p_i, p_j, qn, in_patch) in enumerate(entries):
            n = qn.shape[0]
            conf = np.linalg.norm(qn - cyc_all[k, :n], axis=1)
            conf[~in_patch] = np.inf
            per_job[ji].append(np.stack([
                (out_all[k, :n, 0] - 0.5) * 2 * p_j.w + p_j.x,
                out_all[k, :n, 1] * p_j.h + p_j.y,
                conf,
            ], axis=1))
        results = []
        for ji, (_, _, queries_a) in enumerate(jobs):
            preds = np.stack(per_job[ji])  # (P, N, 3)
            best = preds[np.argmin(preds[..., 2], axis=0),
                         np.arange(preds.shape[1])]
            results.append(np.concatenate(
                [np.asarray(queries_a, np.float64), best[:, :2]], axis=1))
        return results


def _to_float01(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    return img / 255.0 if img.max() > 2.0 else img


def _pair_streams(pair_seeds, n: int, rng: np.random.RandomState) -> list:
    """One RandomState per pair from ints or live streams; without seeds,
    drawn from ``rng``."""
    if pair_seeds is None:
        pair_seeds = [int(rng.randint(2 ** 31 - 1)) for _ in range(n)]
    return [s if isinstance(s, np.random.RandomState)
            else np.random.RandomState(s) for s in pair_seeds]


def _rank_by_cycle_error(corr_f, idx_f, corr_b, idx_b, max_corrs,
                         return_idx, return_cycle_error) -> list:
    """Forward correspondences that survived the backward pass, ordered by
    the distance between the query and where the backward pass lands."""
    cycle_errors = np.linalg.norm(corr_f[idx_b][:, :2] - corr_b[:, 2:],
                                  axis=1)
    order = np.argsort(cycle_errors)
    out = [corr_f[idx_b][order][:max_corrs]]
    if return_idx:
        out.append(idx_f[idx_b][order][:max_corrs])
    if return_cycle_error:
        out.append(cycle_errors[order][:max_corrs])
    return out


class FasterSparseEngine(SparseEngine):
    """Squad-grouped engine: queries that fall inside a pilot task's patch
    window share the pilot's crops, so one canvas encode serves up to
    ``max_load`` queries. Members reuse the *pilot's* crop, which trades a
    little spatial accuracy for throughput.

    Parameters beyond SparseEngine's
    --------------------------------
    max_load: most members that join a pilot (a squad holds max_load + 1).
    safe_area: membership window as a fraction of the pilot's patch, in
        (0, 1]. 0.5 is the reference; larger groups more queries per encode
        at the price of accuracy near the window's edges.
    group_cap, group_bucket, member_bucket, member_ladder: padding and
        chunking of the device calls (inference/grouped.py). group_cap
        bounds the canvases per call; with max_load in the thousands it must
        drop so the (group_cap, max_load + 1, d) decoder buffers fit.
    image_bucket: multi-pair image stacks are padded to multiples of this.
    squads_impl: "native" (the C++ squad formation, built at first use) or
        "numpy".
    """

    def __init__(self, runner: ModelRunner, batch_size: int = 256,
                 mode: str = "stretching", seed: int = 0, max_load: int = 256,
                 crop_dtype=None, safe_area: float = 0.5,
                 group_cap: int = 128, group_bucket: int = 8,
                 member_bucket: int = 64, member_ladder: bool = False,
                 seed_stride: int = 1, image_bucket: int = 256,
                 squads_impl: str = "native"):
        super().__init__(runner, batch_size, mode, seed,
                         crop_dtype=crop_dtype, seed_stride=seed_stride)
        # above 1.0 members would leave the pilot's patch (queries outside
        # the canvas); at or below 0 grouping means nothing
        if not 0.0 < safe_area <= 1.0:
            raise ValueError(f"safe_area must be in (0, 1], got {safe_area}")
        if squads_impl not in ("native", "numpy"):
            raise ValueError(f"squads_impl must be 'native' or 'numpy', got "
                             f"{squads_impl!r}")
        self.max_load = max_load
        self.safe_area = safe_area
        self.group_cap = group_cap
        self.group_bucket = group_bucket
        self.member_bucket = member_bucket
        self.member_ladder = member_ladder
        self.image_bucket = image_bucket
        self.squads_impl = squads_impl
        self._stepper = GroupedStepper(runner, crop_dtype=self.crop_dtype)

    @classmethod
    def from_config(cls, runner: ModelRunner, cfg, **kw):
        """Build from an InferenceConfig."""
        return cls(runner, batch_size=cfg.batch_size, mode=cfg.mode,
                   max_load=cfg.max_load, **kw)

    def _grouping(self) -> dict:
        return dict(max_load=self.max_load, safe_area=self.safe_area,
                    group_cap=self.group_cap, group_bucket=self.group_bucket,
                    member_bucket=self.member_bucket,
                    member_ladder=self.member_ladder,
                    squads_impl=self.squads_impl)

    def _refine_all(self, img_a, img_b, loc_from, loc_to, area_a, area_b,
                    zoom_ins, converge_iters):
        s_from, s_to = relative_scales(area_a, area_b)
        dev_a = self.refiner.prepare_image(img_a)
        dev_b = self.refiner.prepare_image(img_b)
        history = refine_grouped(
            self.runner, self._stepper, dev_a, img_a.shape[:2], dev_b,
            img_b.shape[:2], np.asarray(loc_from, np.float64),
            np.asarray(loc_to, np.float64), s_from, s_to, zoom_ins, self.rng,
            converge_iters=converge_iters, **self._grouping())
        self.total_tasks += history.shape[0] * history.shape[1]
        return np.concatenate([np.asarray(loc_to)[None], history], axis=0)

    # ------------------------------------------------------- multi-pair API

    def _stack_images(self, imgs) -> torch.Tensor:
        """Pad N images to one common shape, multiples of ``image_bucket``,
        and move them to the device as ONE (N, Hp, Wp, 3) [0, 1] stack
        (uint8 crosses as uint8 and converts there)."""
        bucket = self.image_bucket
        hp = max(-(-im.shape[0] // bucket) * bucket for im in imgs)
        wp = max(-(-im.shape[1] // bucket) * bucket for im in imgs)
        all_uint8 = all(im.dtype == np.uint8 for im in imgs)
        stack = np.zeros((len(imgs), hp, wp, 3),
                         np.uint8 if all_uint8 else np.float32)
        for i, im in enumerate(imgs):
            stack[i, :im.shape[0], :im.shape[1]] = \
                im if all_uint8 else _to_float01(im)
        dev = torch.from_numpy(stack).to(self.runner.device).float()
        if all_uint8:
            dev = dev / 255.0
        return dev

    def cotr_corr_multiscale_multipair(
            self, pairs, zoom_ins: Sequence[float] = (1.0,),
            converge_iters: int = 1, max_corrs: int = 1000,
            queries_list=None, force: bool = False, areas_list=None,
            return_idx: bool = False, pair_seeds=None):
        """ONE call refines N image pairs with shared device dispatches: the
        dense seed pass batches every pair's canvases and the refinement
        squads carry a pair index (refine_grouped_pairs), so modest per-pair
        workloads fill the canvas-encode batch.

        pairs: [(img_a, img_b)] * N. ``queries_list`` / ``areas_list``:
        per-pair analogs of ``queries_a`` / ``areas``. ``max_corrs``: a
        scalar or one value per pair. ``pair_seeds``: per-pair seeds (ints,
        or live RandomState streams for callers that chain multipair
        calls); results match N serial ``cotr_corr_multiscale`` calls on
        engines built with ``seed=pair_seeds[i]``, within the float
        tolerance of the changed dispatch composition.

        Returns a list of per-pair corrs (max_corrs, 4), or (corrs, idx)
        tuples with ``return_idx``."""
        n = len(pairs)
        if n == 0:
            return []
        pairs = [(np.asarray(a), np.asarray(b)) for a, b in pairs]
        if queries_list is None:
            queries_list = [None] * n
        queries_list = [None if q is None
                        else np.asarray(q, np.float64).copy()
                        for q in queries_list]
        max_corrs_list = list(max_corrs) if np.ndim(max_corrs) else \
            [int(max_corrs)] * n
        rngs = _pair_streams(pair_seeds, n, self.rng)

        # ---- seed (batched dense pass unless the scales are known)
        if areas_list is not None:
            if any(q is None for q in queries_list) or not force:
                raise ValueError("areas_list needs queries for every pair "
                                 "and force=True")
            # ALL pairs' patch canvases share one batched corr_base pass
            corrs_all = self.corr_base_many(
                [(a, b, q) for (a, b), q in zip(pairs, queries_list)])
            seeds = [(corr[:, :2], corr[:, 2:], np.arange(len(corr)),
                      float(ar[0]), float(ar[1]))
                     for corr, ar in zip(corrs_all, areas_list)]
        else:
            dense = self._dense_fields_many(pairs)
            seeds = [self._seed_tasks(a, b, max_corrs_list[i], q, force,
                                      dense=dense[i], rng=rngs[i])
                     for i, ((a, b), q) in enumerate(zip(pairs,
                                                         queries_list))]

        imgs_a_dev = self._stack_images([a for a, _ in pairs])
        imgs_b_dev = self._stack_images([b for _, b in pairs])

        pair_states = []
        for i, (lf, lt, ident, area_a, area_b) in enumerate(seeds):
            s_from, s_to = relative_scales(area_a, area_b)
            pair_states.append(dict(
                hw_a=pairs[i][0].shape[:2], hw_b=pairs[i][1].shape[:2],
                s_from=s_from, s_to=s_to,
                loc_from=np.asarray(lf, np.float64),
                loc_to=np.asarray(lt, np.float64), rng=rngs[i]))

        hists = refine_grouped_pairs(
            self._stepper, imgs_a_dev, imgs_b_dev, pair_states, zoom_ins,
            converge_iters=converge_iters, **self._grouping())

        results = []
        for i, (lf, lt, ident, _, _) in enumerate(seeds):
            if len(lf) == 0:
                empty = np.zeros((0, 4))
                results.append((empty, np.zeros(0, int)) if return_idx
                               else empty)
                continue
            if np.isnan(hists[i]).any():
                raise ValueError("NaN in refinement predictions")
            self.total_tasks += hists[i].shape[0] * hists[i].shape[1]
            history = np.concatenate(
                [np.asarray(lt, np.float64)[None], hists[i]], axis=0)
            corrs, idx = self._conclude(
                np.asarray(lf, np.float64), history, ident,
                pairs[i][0].shape[:2], pairs[i][1].shape[:2], force)
            corrs, idx = corrs[:max_corrs_list[i]], idx[:max_corrs_list[i]]
            results.append((corrs, idx) if return_idx else corrs)
        return results

    def cotr_corr_multiscale_with_cycle_consistency_multipair(
            self, pairs, zoom_ins: Sequence[float] = (1.0,),
            converge_iters: int = 1, max_corrs: int = 1000,
            queries_list=None, return_idx: bool = False,
            return_cycle_error: bool = False, pair_seeds=None):
        """Bidirectional cycle-ranked matching over MANY pairs: all N
        forward (a->b) jobs share device dispatches, then all N backward
        (b->a) jobs do. Per-pair results match serial
        ``cotr_corr_multiscale_with_cycle_consistency`` calls on engines
        seeded ``pair_seeds[i]``."""
        extraction_rate = 0.3
        n = len(pairs)
        pairs = [(np.asarray(a), np.asarray(b)) for a, b in pairs]
        if queries_list is None:
            queries_list = [None] * n
        # live streams: each pair's forward seeding and refinement and then
        # its backward ones must consume ONE stream in serial order
        rngs = _pair_streams(pair_seeds, n, self.rng)

        temp_max = []
        q_fwd = []
        for q in queries_list:
            tm = int(max_corrs / extraction_rate)
            if q is not None:
                q = np.asarray(q, np.float64).copy()
                tm = min(tm, q.shape[0])
            temp_max.append(tm)
            q_fwd.append(q)

        fwd = self.cotr_corr_multiscale_multipair(
            pairs, zoom_ins=zoom_ins, converge_iters=converge_iters,
            max_corrs=temp_max, queries_list=q_fwd, return_idx=True,
            pair_seeds=rngs)
        for i, (corr_f, _) in enumerate(fwd):
            if corr_f.shape[0] == 0:
                raise RuntimeError(
                    f"forward pass produced no correspondences (pair {i})")

        bwd = self.cotr_corr_multiscale_multipair(
            [(b, a) for a, b in pairs], zoom_ins=zoom_ins,
            converge_iters=converge_iters,
            max_corrs=[corr_f.shape[0] for corr_f, _ in fwd],
            queries_list=[corr_f[:, 2:].copy() for corr_f, _ in fwd],
            return_idx=True, pair_seeds=rngs)

        results = []
        for i in range(n):
            corr_f, idx_f = fwd[i]
            corr_b, idx_b = bwd[i]
            if corr_b.shape[0] == 0:
                raise RuntimeError(
                    f"backward pass produced no correspondences (pair {i})")
            out = _rank_by_cycle_error(corr_f, idx_f, corr_b, idx_b,
                                       max_corrs, return_idx,
                                       return_cycle_error)
            results.append(out[0] if len(out) == 1 else tuple(out))
        return results
