"""Squad (grouped) refinement: many queries share one crop-pair encode
(counterpart of cotr_tpu/inference/grouped.py).

At each zoom level, tasks whose (loc_from, loc_to) both fall inside a pilot
task's SAFE_AREA patch window reuse the pilot's crops, so one canvas encode
serves up to ``max_load`` queries, and the encodes of all squads are batched.

Per zoom level:
  host   greedy squad formation over the task positions (numpy, or the C++
         twin in csrc/squads.cpp);
  device crop G pilot patch pairs, encode the G canvases, decode the (G, M)
         padded query matrix in one call;
  host   map each member's prediction back through its squad's target patch.

Everything on the host is numpy in float64, line by line what the JAX
package does, and draws from ``np.random.RandomState`` in the same order, so
both packages form the same squads. The group and member axes are padded to
the same few sizes as there (``group_bucket`` or ``group_cap`` canvases,
``member_bucket`` or ``max_load + 1`` members), which keeps
``dispatch_count`` and ``canvas_count`` equal to the JAX engine's;
``group_cap`` and ``CELL_CAP`` also bound the device memory of one call.

With a local mesh (``parallel.mesh``) the stepper splits the squad axis of
every dispatch over the mesh's devices, as the JAX package shards it over
its mesh: each device crops, encodes and decodes its share of the squads
with its own copy of the model and images, and no collective runs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from cotr_tpu_torch import native
from cotr_tpu_torch.ops.canvas import normalize_canvas
from cotr_tpu_torch.ops.sampling import (crop_and_resize_matmul,
                                         crop_and_resize_window_indexed,
                                         crop_and_resize_windowed)
from cotr_tpu_torch.parallel.mesh import (LocalMesh, replicate,
                                          require_local_mesh)
from cotr_tpu_torch.utils.constants import MAX_SIZE
from cotr_tpu_torch.utils.profiling import span

SAFE_AREA = 0.5
# ladder-mode dispatch budget: canvases x padded members per device call.
# Bounds the decoder's (G, M, d) activations while small-member chunks still
# fill the canvas-encode batch.
CELL_CAP = 32768


def window_ladder(size: float, image_min_dim: int, step: int = 64) -> int:
    """Quantize a patch size up to the next multiple of ``step``, so the
    indexed crop sees few window sizes. Never exceeds the padded image
    dimension (image stacks are padded to multiples of 256)."""
    q = -(-max(int(size), 1) // step) * step
    return min(q, image_min_dim)


def patch_box_np(pos: np.ndarray, scale: float, h: int, w: int
                 ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Vectorized numpy twin of refine.patch_box, in float64 with Python's
    int() truncation."""
    short = min(h, w)
    size = float(int(short * np.clip(scale, 0.0, 1.0)) // 2 * 2)
    half = size // 2
    lu_x = np.clip(np.floor(pos[..., 0] - half), 0, w - size)
    lu_y = np.clip(np.floor(pos[..., 1] - half), 0, h - size)
    return lu_x, lu_y, size


def form_squads(loc_from: np.ndarray, loc_to: np.ndarray, active: np.ndarray,
                scale_from: float, scale_to: float,
                hw_a: Tuple[int, int], hw_b: Tuple[int, int],
                max_load: int, rng: np.random.RandomState,
                safe_area: float = SAFE_AREA, impl: str = "native"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy squad formation.

    ``safe_area`` is the membership window as a fraction of the pilot's
    patch (0.5 in the reference). Larger values group more queries per
    canvas encode, at the price of accuracy near the window's edges (a
    member reuses the pilot's target crop).

    ``impl``: ``"native"`` runs the grid-bucketed C++ twin (built at first
    use; a failed build raises), ``"numpy"`` the O(P*T) scan. Same order,
    same result. One ``rng.permutation`` is drawn per call.

    Returns (squad_of: (T,) squad index or -1, pilots: (G,) task ids).
    """
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl must be 'native' or 'numpy', got {impl!r}")
    ids = np.where(active)[0]
    order = ids[rng.permutation(len(ids))]

    x0f, y0f, sf = patch_box_np(loc_from, scale_from, *hw_a)
    x0t, y0t, st = patch_box_np(loc_to, scale_to, *hw_b)
    cf_x, cf_y = x0f + sf / 2, y0f + sf / 2
    ct_x, ct_y = x0t + st / 2, y0t + st / 2
    half_f = sf / 2 * safe_area
    half_t = st / 2 * safe_area

    if impl == "native":
        return native.form_squads(loc_from, loc_to, cf_x, cf_y, ct_x, ct_y,
                                  active, half_f, half_t, order, max_load)
    return _form_squads_numpy(loc_from, loc_to, active, cf_x, cf_y,
                              ct_x, ct_y, half_f, half_t, order, max_load)


def _form_squads_numpy(loc_from, loc_to, active, cf_x, cf_y, ct_x, ct_y,
                       half_f, half_t, order, max_load
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """O(P*T) numpy scan: what the native version must equal."""
    t = len(loc_from)
    squad_of = np.full(t, -1, int)
    free = np.zeros(t, bool)
    free[np.where(active)[0]] = True
    pilots = []
    for pid in order:
        if not free[pid]:
            continue
        g = len(pilots)
        pilots.append(pid)
        # the pilot is claimed FIRST, so the max_load cap can never cut it
        # out of its own squad (it would then keep its unrefined value
        # through the final zoom's revisit check)
        squad_of[pid] = g
        free[pid] = False
        inside = (free &
                  (np.abs(loc_from[:, 0] - cf_x[pid]) < half_f) &
                  (np.abs(loc_from[:, 1] - cf_y[pid]) < half_f) &
                  (np.abs(loc_to[:, 0] - ct_x[pid]) < half_t) &
                  (np.abs(loc_to[:, 1] - ct_y[pid]) < half_t))
        # up to max_load OTHER members join
        members = np.where(inside)[0][:max_load]
        squad_of[members] = g
        free[members] = False
    return squad_of, np.asarray(pilots, int)


def _squad_tables(loc_from, squad_of, g, x0f_all, y0f_all, sf
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat member table by one stable argsort: (ids_full (G, m_cap) with -1
    padding, q_full (G, m_cap, 2) canvas-local queries, counts (G,))."""
    midx = np.where(squad_of >= 0)[0]
    sq = squad_of[midx]
    o = np.argsort(sq, kind="stable")
    midx, sq = midx[o], sq[o]
    counts = np.bincount(sq, minlength=g)
    starts0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(midx)) - starts0[sq]
    m_cap = max(int(counts.max()), 1)
    ids_full = np.full((g, m_cap), -1, int)
    ids_full[sq, pos] = midx
    q_full = np.zeros((g, m_cap, 2), np.float32)
    q_full[sq, pos, 0] = (loc_from[midx, 0] - x0f_all[sq]) / (2 * sf)
    q_full[sq, pos, 1] = (loc_from[midx, 1] - y0f_all[sq]) / sf
    return ids_full, q_full, counts


class GroupedStepper:
    """The device step: (G pilot boxes, (G, M) queries) -> predictions, on
    the runner's device, under ``torch.inference_mode()``.

    With a local ``mesh`` the squad axis G is split in equal shares over
    the mesh's devices, in order (G must be a multiple of the mesh's size:
    the engine's ``group_bucket`` and ``group_cap`` are); the model is
    copied once to each distinct device other than the runner's, the images
    at each dispatch, and the predictions come back on the runner's device
    in squad order.

    ``dispatch_count`` and ``canvas_count`` count device calls and padded
    canvas rows since construction, over all devices, as the JAX package
    counts them; ``device_canvas_count`` counts the canvas rows of each
    entry of the mesh (one entry without a mesh).
    """

    def __init__(self, runner, crop_dtype=torch.float32,
                 mesh: Optional[LocalMesh] = None):
        self.runner = runner
        self._crop_dtype = crop_dtype
        self.mesh = None if mesh is None else \
            require_local_mesh(mesh, "GroupedStepper")
        self._models = [runner.model] if mesh is None else \
            replicate(runner.model, self.mesh, home=runner.device)
        self.dispatch_count = 0
        self.canvas_count = 0
        self.device_canvas_count = [0] * len(self._models)

    def _upload(self, array, device, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(
            device, dtype)

    def _encode_decode(self, model, crops_a, crops_b, queries
                       ) -> torch.Tensor:
        canvas = normalize_canvas(torch.cat([crops_a, crops_b], dim=2))
        del crops_a, crops_b
        memory = model.encode(canvas)
        del canvas
        return model.decode(memory, self._upload(queries, memory.device))

    def _shares(self, n: int) -> list:
        """Each mesh entry's (index, model, slice) of ``n`` squads."""
        k = len(self._models)
        if n % k:
            raise ValueError(f"{n} squads do not split over the mesh's {k} "
                             "devices: group_bucket and group_cap must be "
                             "multiples of its size")
        per = n // k
        return [(i, model, slice(i * per, (i + 1) * per))
                for i, model in enumerate(self._models)]

    def _gather(self, parts) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.runner.device) for p in parts], dim=0)

    def _step_for(self, boxes_from: np.ndarray, boxes_to: np.ndarray
                  ) -> Tuple:
        """(size_from, size_to) for the windowed crop when every box of the
        dispatch shares one square integral size AND has integral corners
        (always so for engine dispatches: patch_box_np floors its corners
        and the patch size depends on the zoom and the image alone);
        otherwise (None, None), the generic full-image crop, which also
        takes fractional corners."""
        def uniform_size(b):
            if len(b) == 0:
                return None
            s = b[0, 2]
            if (s > 0 and s == int(s) and np.all(b[:, 2] == s)
                    and np.all(b[:, 3] == s)
                    and np.array_equal(b[:, :2], np.floor(b[:, :2]))):
                return int(s)
            return None

        sf = uniform_size(boxes_from)
        st = uniform_size(boxes_to)
        if sf is None or st is None:
            return None, None
        return sf, st

    def _crop(self, img, boxes: np.ndarray, size):
        if size is None:
            return crop_and_resize_matmul(
                img, self._upload(boxes, img.device), MAX_SIZE,
                compute_dtype=self._crop_dtype)
        return crop_and_resize_windowed(img, boxes, MAX_SIZE, size,
                                        compute_dtype=self._crop_dtype)

    @torch.inference_mode()
    def dispatch(self, img_a, img_b, boxes_from, boxes_to, queries):
        """Enqueue one step WITHOUT synchronizing; returns the device
        tensor. Chunks within a zoom level are independent, so the engine
        dispatches them all and reads them afterwards: the host builds chunk
        k+1 while the device computes chunk k."""
        boxes_from = np.asarray(boxes_from, np.float32)
        boxes_to = np.asarray(boxes_to, np.float32)
        queries = np.asarray(queries, np.float32)
        size_f, size_t = self._step_for(boxes_from, boxes_to)
        shares = self._shares(len(boxes_from))
        self.dispatch_count += 1
        self.canvas_count += len(boxes_from)
        imgs_a = self._replicas(img_a)
        imgs_b = self._replicas(img_b)
        parts = []
        for i, model, sl in shares:
            self.device_canvas_count[i] += sl.stop - sl.start
            parts.append(self._encode_decode(
                model, self._crop(imgs_a[i], boxes_from[sl], size_f),
                self._crop(imgs_b[i], boxes_to[sl], size_t), queries[sl]))
        return self._gather(parts)

    def _replicas(self, tensor) -> list:
        if self.mesh is None:
            return [tensor]
        return replicate(tensor, self.mesh)

    @torch.inference_mode()
    def dispatch_indexed(self, imgs_a, imgs_b, idx, boxes_from, boxes_to,
                         queries):
        """Multi-pair step without synchronizing: image STACKS (P, H, W, 3)
        and one pair index per squad, so squads of different image pairs
        share one canvas-encode call. Window sizes go up the ladder of
        :func:`window_ladder`."""
        boxes_from = np.asarray(boxes_from, np.float32)
        boxes_to = np.asarray(boxes_to, np.float32)
        queries = np.asarray(queries, np.float32)
        idx = np.asarray(idx, np.int32)
        min_a = min(int(imgs_a.shape[1]), int(imgs_a.shape[2]))
        min_b = min(int(imgs_b.shape[1]), int(imgs_b.shape[2]))
        wf = window_ladder(
            float(boxes_from[:, 2].max()) if len(boxes_from) else 1.0, min_a)
        wt = window_ladder(
            float(boxes_to[:, 2].max()) if len(boxes_to) else 1.0, min_b)
        shares = self._shares(len(boxes_from))
        self.dispatch_count += 1
        self.canvas_count += len(boxes_from)
        stacks_a = self._replicas(imgs_a)
        stacks_b = self._replicas(imgs_b)
        parts = []
        for i, model, sl in shares:
            self.device_canvas_count[i] += sl.stop - sl.start
            crops_a = crop_and_resize_window_indexed(
                stacks_a[i], boxes_from[sl], idx[sl], MAX_SIZE, wf,
                compute_dtype=self._crop_dtype)
            crops_b = crop_and_resize_window_indexed(
                stacks_b[i], boxes_to[sl], idx[sl], MAX_SIZE, wt,
                compute_dtype=self._crop_dtype)
            parts.append(self._encode_decode(model, crops_a, crops_b,
                                             queries[sl]))
        return self._gather(parts)

    def __call__(self, img_a, img_b, boxes_from, boxes_to, queries):
        return self.dispatch(img_a, img_b, boxes_from, boxes_to,
                             queries).cpu().numpy()


def _to_host(preds) -> np.ndarray:
    """A dispatch's predictions as a host array; for a device tensor this is
    where the host waits."""
    return preds.cpu().numpy() if torch.is_tensor(preds) \
        else np.asarray(preds)


def _member_pad(m_max, max_load, member_bucket, member_ladder):
    """Padded member-axis size of one dispatch chunk: ``member_bucket`` or
    ``max_load + 1``; with ``member_ladder`` the next power of two between
    them (at most 2x padding, for dense clustered workloads whose first zoom
    level packs thousands of members a squad and whose deepest packs about
    a hundred)."""
    cap = max(max_load + 1, member_bucket)
    if not member_ladder:
        return member_bucket if m_max <= member_bucket else cap
    return min(max(member_bucket, 1 << (m_max - 1).bit_length()), cap)


def _grouped_zoom_step(stepper, img_a_dev, img_b_dev, loc_from, loc_to,
                       active, scale_f, scale_t, hw_a, hw_b, rng, max_load,
                       group_bucket, member_bucket, group_cap,
                       safe_area=SAFE_AREA, member_ladder=False,
                       squads_impl="native"):
    """One squad formation and device dispatch over the ``active`` tasks.

    Updates loc_to in place for every active task (each belongs to exactly
    one squad). Returns the number of squads formed.
    """
    h_a, w_a = hw_a
    h_b, w_b = hw_b
    with span("cotr.squad.form"):
        squad_of, pilots = form_squads(loc_from, loc_to, active, scale_f,
                                       scale_t, (h_a, w_a), (h_b, w_b),
                                       max_load, rng, safe_area=safe_area,
                                       impl=squads_impl)
        g = len(pilots)
        if g == 0:
            return 0
        x0f_all, y0f_all, sf = patch_box_np(loc_from[pilots], scale_f, h_a,
                                            w_a)
        x0t_all, y0t_all, st = patch_box_np(loc_to[pilots], scale_t, h_b,
                                            w_b)
        ids_full, q_full, counts = _squad_tables(loc_from, squad_of, g,
                                                 x0f_all, y0f_all, sf)
    m_cap = ids_full.shape[1]

    # dispatch every chunk first (device queue), read afterwards. Ladder
    # mode takes squads in descending member count under a cell budget
    # (g_chunk x m_pad <= CELL_CAP): one zoom level of a dense grid mixes
    # 4000-member squads with 60-member squads, and one (group_cap,
    # max_load+1) shape would exhaust memory or pad the small squads 60x.
    order = np.argsort(-counts, kind="stable") if member_ladder \
        else np.arange(g)
    inflight = []
    start = 0
    while start < g:
        if member_ladder:
            m_pad = _member_pad(max(int(counts[order[start]]), 1),
                                max_load, member_bucket, True)
            gc = min(group_cap, max(1, CELL_CAP // m_pad), g - start)
            g_pad = group_bucket if gc <= group_bucket \
                else min(1 << (gc - 1).bit_length(), group_cap)
        else:
            gc = min(group_cap, g - start)
            m_max = max(int(counts[order[start:start + gc]].max()), 1)
            # exactly two sizes per axis, as in the JAX package
            m_pad = _member_pad(m_max, max_load, member_bucket, False)
            g_pad = group_bucket if gc <= group_bucket else group_cap
        sel = order[start:start + gc]
        start += gc

        queries = np.zeros((g_pad, m_pad, 2), np.float32)
        member_ids = np.full((g_pad, m_pad), -1, int)
        mc = min(m_cap, m_pad)
        queries[:gc, :mc] = q_full[sel, :mc]
        member_ids[:gc, :mc] = ids_full[sel, :mc]

        boxes_from = np.zeros((g_pad, 4), np.float32)
        boxes_to = np.zeros((g_pad, 4), np.float32)
        boxes_from[:gc] = np.stack(
            [x0f_all[sel], y0f_all[sel],
             np.full(gc, sf), np.full(gc, sf)], axis=1)
        boxes_to[:gc] = np.stack(
            [x0t_all[sel], y0t_all[sel],
             np.full(gc, st), np.full(gc, st)], axis=1)
        # padding boxes keep the level's patch size (at 0, 0) so one window
        # size covers the whole dispatch; their results are ignored
        boxes_from[gc:, 2:] = sf
        boxes_to[gc:, 2:] = st

        # fake steppers in tests may only implement __call__ (sync)
        dispatch = getattr(stepper, "dispatch", stepper)
        preds_dev = dispatch(img_a_dev, img_b_dev, boxes_from,
                             boxes_to, queries)
        x0t_rows = np.zeros(g_pad)
        y0t_rows = np.zeros(g_pad)
        x0t_rows[:gc] = x0t_all[sel]
        y0t_rows[:gc] = y0t_all[sel]
        inflight.append((preds_dev, member_ids, x0t_rows, y0t_rows))

    for preds_dev, member_ids, x0t_rows, y0t_rows in inflight:
        preds = _to_host(preds_dev)
        # back through each squad's target patch, vectorized
        new_x = (preds[..., 0] - 0.5) * 2 * st + x0t_rows[:, None]
        new_y = preds[..., 1] * st + y0t_rows[:, None]
        sel = member_ids >= 0
        loc_to[member_ids[sel], 0] = new_x[sel]
        loc_to[member_ids[sel], 1] = new_y[sel]
    return g


def _settle_final_zoom(loc_to, zoom_hist, active, it, iters) -> np.ndarray:
    """The final zoom's convergence rule after iteration ``it``: a task
    freezes on the first exact revisit of an earlier final-zoom prediction,
    taking the mean of the loop it found, or on its last iteration. Writes
    ``loc_to`` and ``zoom_hist`` in place; returns the tasks still active."""
    eq = np.all(zoom_hist[:it] == loc_to[None], axis=-1) \
        if it else np.zeros((0, len(loc_to)), bool)            # (it, T)
    has_loop = eq.any(axis=0) & active
    zoom_hist[it] = loc_to
    # loop average: mean of zoom_hist[first_match .. it-1]
    for ti in np.where(has_loop)[0]:
        j0 = int(eq[:, ti].argmax())
        loc_to[ti] = zoom_hist[j0:it, ti].mean(axis=0)
    freeze = has_loop | (active & (it == iters - 1))
    return active & ~freeze


def refine_grouped(runner, stepper: GroupedStepper, img_a_dev, hw_a,
                   img_b_dev, hw_b,
                   loc_from: np.ndarray, loc_to0: np.ndarray,
                   s_from: float, s_to: float, zoom_ins: Sequence[float],
                   rng: np.random.RandomState, converge_iters: int = 1,
                   max_load: int = 256, group_bucket: int = 8,
                   member_bucket: int = 64, group_cap: int = 128,
                   safe_area: float = SAFE_AREA, member_ladder: bool = False,
                   squads_impl: str = "native") -> np.ndarray:
    """Zoom-major grouped refinement over all tasks.

    Returns the per-zoom-level loc_to history (len(zoom_ins), T, 2): one row
    per level, the final row converged.

    At the final zoom, squads re-form each iteration among the tasks still
    active; a task freezes on the first exact revisit of an earlier
    final-zoom prediction, taking the mean of the detected loop, or on its
    ``converge_iters``-th iteration.

    At most ``group_cap`` canvases go into one device call: when grouping
    degenerates (every task its own squad) the encoder's per-canvas
    attention buffers would otherwise grow with the task count.
    """
    with span("cotr.squad.refine"):
        t = len(loc_from)
        loc_to = loc_to0.astype(np.float64).copy()
        history = []
        n_levels = len(zoom_ins)

        for zi, zoom in enumerate(zoom_ins):
            scale_f, scale_t = s_from * zoom, s_to * zoom
            is_final = zi == n_levels - 1
            iters = converge_iters if is_final else 1
            active = np.ones(t, bool)
            zoom_hist = np.zeros((iters, t, 2))

            for it in range(iters):
                if not active.any():
                    break
                _grouped_zoom_step(stepper, img_a_dev, img_b_dev, loc_from,
                                   loc_to, active, scale_f, scale_t, hw_a,
                                   hw_b, rng, max_load, group_bucket,
                                   member_bucket, group_cap,
                                   safe_area=safe_area,
                                   member_ladder=member_ladder,
                                   squads_impl=squads_impl)
                if not is_final:
                    break
                active = _settle_final_zoom(loc_to, zoom_hist, active, it,
                                            iters)
            history.append(loc_to.copy())

        return np.stack(history, axis=0)


def refine_grouped_pairs(stepper: GroupedStepper, imgs_a_dev, imgs_b_dev,
                         pairs: Sequence[dict], zoom_ins: Sequence[float],
                         converge_iters: int = 1, max_load: int = 256,
                         group_bucket: int = 8, member_bucket: int = 64,
                         group_cap: int = 128, safe_area: float = SAFE_AREA,
                         member_ladder: bool = False,
                         squads_impl: str = "native") -> list:
    """Zoom-major grouped refinement over MANY image pairs at once.

    Every pair's squads at one zoom level share device dispatches (a pair
    index per squad gathers the right images), so small per-pair workloads
    fill the canvas-encode batch instead of paying one dispatch per pair.

    ``pairs``: one dict per pair with keys
      hw_a, hw_b    true (h, w) extents inside the padded stacks;
      s_from, s_to  relative base scales (relative_scales);
      loc_from      (T_p, 2) fixed query positions in image a;
      loc_to        (T_p, 2) initial target estimates in image b;
      rng           np.random.RandomState driving THIS pair's squad
                    formation (a stream per pair keeps the squads those of
                    serial single-pair runs with the same seeds).
    ``imgs_a_dev`` / ``imgs_b_dev``: (P, Hp, Wp, 3) [0, 1] float stacks, all
    pairs padded to one common shape.

    Returns one (len(zoom_ins), T_p, 2) history per pair (refine_grouped
    semantics).
    """
    with span("cotr.squad.refine"):
        n_pairs = len(pairs)
        n_levels = len(zoom_ins)
        locs = [np.asarray(p["loc_to"], np.float64).copy() for p in pairs]
        loc_froms = [np.asarray(p["loc_from"], np.float64) for p in pairs]
        histories: list = [[] for _ in range(n_pairs)]

        for zi, zoom in enumerate(zoom_ins):
            is_final = zi == n_levels - 1
            iters = converge_iters if is_final else 1
            actives = [np.ones(len(lf), bool) for lf in loc_froms]
            zoom_hists = [np.zeros((iters, len(lf), 2)) for lf in loc_froms]

            for it in range(iters):
                if not any(a.any() for a in actives):
                    break
                # ---- per-pair squad formation, concatenated dispatch tables
                with span("cotr.squad.form"):
                    per_pair = []
                    m_cap = 1
                    for pi, p in enumerate(pairs):
                        active = actives[pi]
                        if not active.any():
                            continue
                        h_a, w_a = p["hw_a"]
                        h_b, w_b = p["hw_b"]
                        scale_f = p["s_from"] * zoom
                        scale_t = p["s_to"] * zoom
                        squad_of, pilots = form_squads(
                            loc_froms[pi], locs[pi], active, scale_f, scale_t,
                            (h_a, w_a), (h_b, w_b), max_load, p["rng"],
                            safe_area=safe_area, impl=squads_impl)
                        g = len(pilots)
                        if g == 0:
                            continue
                        x0f, y0f, sf = patch_box_np(loc_froms[pi][pilots],
                                                    scale_f, h_a, w_a)
                        x0t, y0t, st = patch_box_np(locs[pi][pilots], scale_t,
                                                    h_b, w_b)
                        ids_full, q_full, counts = _squad_tables(
                            loc_froms[pi], squad_of, g, x0f, y0f, sf)
                        m_cap = max(m_cap, ids_full.shape[1])
                        boxes_f = np.stack([x0f, y0f, np.full(g, sf),
                                            np.full(g, sf)], axis=1)
                        boxes_t = np.stack([x0t, y0t, np.full(g, st),
                                            np.full(g, st)], axis=1)
                        per_pair.append((pi, boxes_f, boxes_t, ids_full,
                                         q_full, counts, st))
                    if not per_pair:
                        for pi in range(n_pairs):
                            zoom_hists[pi][it] = locs[pi]
                        continue

                    g_tot = sum(len(e[1]) for e in per_pair)
                    boxes_f = np.zeros((g_tot, 4), np.float32)
                    boxes_t = np.zeros((g_tot, 4), np.float32)
                    idx = np.zeros(g_tot, np.int32)
                    ids_all = np.full((g_tot, m_cap), -1, int)
                    q_all = np.zeros((g_tot, m_cap, 2), np.float32)
                    counts_all = np.zeros(g_tot, int)
                    st_rows = np.zeros(g_tot)
                    at = 0
                    for pi, bf, bt, ids_full, q_full, counts, st in per_pair:
                        g = len(bf)
                        boxes_f[at:at + g] = bf
                        boxes_t[at:at + g] = bt
                        idx[at:at + g] = pi
                        ids_all[at:at + g, :ids_full.shape[1]] = ids_full
                        q_all[at:at + g, :q_full.shape[1]] = q_full
                        counts_all[at:at + g] = counts
                        st_rows[at:at + g] = st
                        at += g

                # ---- chunked dispatch (the padding of _grouped_zoom_step)
                inflight = []
                for start in range(0, g_tot, group_cap):
                    end = min(start + group_cap, g_tot)
                    gc = end - start
                    m_max = max(int(counts_all[start:end].max()), 1)
                    m_pad = _member_pad(m_max, max_load, member_bucket,
                                        member_ladder)
                    g_pad = group_bucket if gc <= group_bucket else group_cap

                    queries = np.zeros((g_pad, m_pad, 2), np.float32)
                    member_ids = np.full((g_pad, m_pad), -1, int)
                    mc = min(m_cap, m_pad)
                    queries[:gc, :mc] = q_all[start:end, :mc]
                    member_ids[:gc, :mc] = ids_all[start:end, :mc]
                    bf = np.zeros((g_pad, 4), np.float32)
                    bt = np.zeros((g_pad, 4), np.float32)
                    ix = np.zeros(g_pad, np.int32)
                    bf[:gc] = boxes_f[start:end]
                    bt[:gc] = boxes_t[start:end]
                    ix[:gc] = idx[start:end]
                    # padding boxes take the chunk's largest patch size at
                    # (0, 0) of pair 0, so the ladder window covers them; their
                    # results are ignored
                    bf[gc:, 2:] = boxes_f[start:end, 2].max() if gc else 1.0
                    bt[gc:, 2:] = boxes_t[start:end, 2].max() if gc else 1.0

                    preds_dev = stepper.dispatch_indexed(
                        imgs_a_dev, imgs_b_dev, ix, bf, bt, queries)
                    x0t_r = np.zeros(g_pad)
                    y0t_r = np.zeros(g_pad)
                    st_r = np.ones(g_pad)
                    pr = np.full(g_pad, -1, int)
                    x0t_r[:gc] = boxes_t[start:end, 0]
                    y0t_r[:gc] = boxes_t[start:end, 1]
                    st_r[:gc] = st_rows[start:end]
                    pr[:gc] = idx[start:end]
                    inflight.append((preds_dev, member_ids, x0t_r, y0t_r, st_r,
                                     pr))

                for preds_dev, member_ids, x0t_r, y0t_r, st_r, pr in inflight:
                    preds = _to_host(preds_dev)
                    new_x = (preds[..., 0] - 0.5) * 2 * st_r[:, None] \
                        + x0t_r[:, None]
                    new_y = preds[..., 1] * st_r[:, None] + y0t_r[:, None]
                    for pi in np.unique(pr):
                        if pi < 0:
                            continue
                        rows = pr == pi
                        sel = member_ids[rows] >= 0
                        locs[pi][member_ids[rows][sel], 0] = new_x[rows][sel]
                        locs[pi][member_ids[rows][sel], 1] = new_y[rows][sel]

                if not is_final:
                    break
                # ---- per-pair final-zoom convergence (refine_grouped's rule)
                for pi in range(n_pairs):
                    actives[pi] = _settle_final_zoom(
                        locs[pi], zoom_hists[pi], actives[pi], it, iters)

            for pi in range(n_pairs):
                histories[pi].append(locs[pi].copy())

        return [np.stack(h, axis=0) for h in histories]
