"""Squad (grouped) refinement: many queries share one crop-pair encode
(counterpart of cotr_tpu/inference/grouped.py).

At each zoom level, tasks whose (loc_from, loc_to) both fall inside a pilot
task's SAFE_AREA patch window reuse the pilot's crops, so one canvas encode
serves up to ``max_load`` queries, and the encodes of all squads are batched.

Per zoom level, for one image pair or many (``_zoom_level``):
  host   greedy squad formation over each pair's tasks (csrc/squads.cpp),
         the pairs' squad tables concatenated with a pair index a row;
  device crop G pilot patch pairs, encode the G canvases, decode the (G, M)
         padded query matrix in one call: ``GroupedStepper.dispatch`` on one
         pair's images (``refine_grouped``) or ``dispatch_indexed`` on image
         stacks (``refine_grouped_pairs``);
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

    def _crop(self, img, boxes: np.ndarray, size, sl):
        if size is None:
            return crop_and_resize_matmul(
                img, self._upload(boxes[sl], img.device), MAX_SIZE,
                compute_dtype=self._crop_dtype)
        return crop_and_resize_windowed(img, boxes[sl], MAX_SIZE, size,
                                        compute_dtype=self._crop_dtype)

    def dispatch(self, img_a, img_b, boxes_from, boxes_to, queries):
        """Enqueue one step WITHOUT synchronizing; returns the device
        tensor. Chunks within a zoom level are independent, so the engine
        dispatches them all and reads them afterwards: the host builds chunk
        k+1 while the device computes chunk k."""
        return self._dispatch(img_a, img_b, boxes_from, boxes_to, queries,
                              self._step_for, self._crop)

    def _replicas(self, tensor) -> list:
        if self.mesh is None:
            return [tensor]
        return replicate(tensor, self.mesh)

    def dispatch_indexed(self, imgs_a, imgs_b, idx, boxes_from, boxes_to,
                         queries):
        """Multi-pair step without synchronizing: image STACKS (P, H, W, 3)
        and one pair index per squad, so squads of different image pairs
        share one canvas-encode call. Window sizes go up the ladder of
        :func:`window_ladder`."""
        idx = np.asarray(idx, np.int32)

        def windows(boxes_from, boxes_to):
            return tuple(
                window_ladder(float(b[:, 2].max()) if len(b) else 1.0,
                              min(int(stack.shape[1]), int(stack.shape[2])))
                for b, stack in ((boxes_from, imgs_a), (boxes_to, imgs_b)))

        def crop(stack, boxes, window, sl):
            return crop_and_resize_window_indexed(
                stack, boxes[sl], idx[sl], MAX_SIZE, window,
                compute_dtype=self._crop_dtype)

        return self._dispatch(imgs_a, imgs_b, boxes_from, boxes_to, queries,
                              windows, crop)

    @torch.inference_mode()
    def _dispatch(self, img_a, img_b, boxes_from, boxes_to, queries,
                  windows, crop):
        """The body of both dispatches, which differ only in how a side is
        cropped: ``windows(boxes_from, boxes_to)`` gives each side's window
        and ``crop(image, boxes, window, share)`` one share's crops."""
        boxes_from = np.asarray(boxes_from, np.float32)
        boxes_to = np.asarray(boxes_to, np.float32)
        queries = np.asarray(queries, np.float32)
        win_f, win_t = windows(boxes_from, boxes_to)
        shares = self._shares(len(boxes_from))
        self.dispatch_count += 1
        self.canvas_count += len(boxes_from)
        imgs_a = self._replicas(img_a)
        imgs_b = self._replicas(img_b)
        parts = []
        for i, model, sl in shares:
            self.device_canvas_count[i] += sl.stop - sl.start
            parts.append(self._encode_decode(
                model, crop(imgs_a[i], boxes_from, win_f, sl),
                crop(imgs_b[i], boxes_to, win_t, sl), queries[sl]))
        return self._gather(parts)

    def __call__(self, img_a, img_b, boxes_from, boxes_to, queries):
        return self.dispatch(img_a, img_b, boxes_from, boxes_to,
                             queries).cpu().numpy()


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


def _chunk_plan(counts, max_load, group_bucket, member_bucket, group_cap,
                member_ladder, by_load):
    """The device calls of one zoom level: (rows of the squad table, padded
    canvases, padded members) for each. The rows are an index array, or a
    slice in table order, whose tables are views.

    ``by_load`` takes squads in descending member count under a cell budget
    (canvases x padded members <= CELL_CAP): one zoom level of a dense grid
    mixes 4000-member squads with 60-member squads, and one (group_cap,
    max_load + 1) shape would exhaust memory or pad the small squads 60x.
    Otherwise chunks of ``group_cap`` squads go in table order, with two
    sizes on the canvas axis. Both are the JAX package's plans: by load for
    one pair with ``member_ladder``, in table order for many pairs."""
    g = len(counts)
    order = np.argsort(-counts, kind="stable") if by_load else None
    start = 0
    while start < g:
        if by_load:
            m_pad = _member_pad(max(int(counts[order[start]]), 1),
                                max_load, member_bucket, True)
            gc = min(group_cap, max(1, CELL_CAP // m_pad), g - start)
            g_pad = group_bucket if gc <= group_bucket \
                else min(1 << (gc - 1).bit_length(), group_cap)
            yield order[start:start + gc], g_pad, m_pad
        else:
            gc = min(group_cap, g - start)
            m_max = max(int(counts[start:start + gc].max()), 1)
            m_pad = _member_pad(m_max, max_load, member_bucket, member_ladder)
            g_pad = group_bucket if gc <= group_bucket else group_cap
            yield slice(start, start + gc), g_pad, m_pad
        start += gc


def _pair_tables(pair, active, zoom, max_load, safe_area):
    """One pair's squads over its ``active`` tasks at one zoom level:
    (boxes_from, boxes_to, member ids, canvas-local queries, member counts,
    target patch size), one row per squad."""
    h_a, w_a = pair["hw_a"]
    h_b, w_b = pair["hw_b"]
    scale_f, scale_t = pair["s_from"] * zoom, pair["s_to"] * zoom
    loc_from, loc_to = pair["loc_from"], pair["loc_to"]
    squad_of, pilots = form_squads(loc_from, loc_to, active, scale_f, scale_t,
                                   (h_a, w_a), (h_b, w_b), max_load,
                                   pair["rng"], safe_area=safe_area)
    g = len(pilots)
    x0f, y0f, sf = patch_box_np(loc_from[pilots], scale_f, h_a, w_a)
    x0t, y0t, st = patch_box_np(loc_to[pilots], scale_t, h_b, w_b)
    ids, queries, counts = _squad_tables(loc_from, squad_of, g, x0f, y0f, sf)
    boxes_f = np.stack([x0f, y0f, np.full(g, sf), np.full(g, sf)], axis=1)
    boxes_t = np.stack([x0t, y0t, np.full(g, st), np.full(g, st)], axis=1)
    return boxes_f, boxes_t, ids, queries, counts, st


def _zoom_level(stepper, imgs_a, imgs_b, pairs, actives, zoom, indexed,
                max_load, group_bucket, member_bucket, group_cap, safe_area,
                member_ladder):
    """One squad formation and device pass over the active tasks of every
    pair. Writes each active task's ``loc_to`` in place (each belongs to
    exactly one squad).

    ``indexed`` picks the route: ``stepper.dispatch_indexed`` over image
    stacks with a pair index per squad, or ``stepper.dispatch`` over one
    pair's images."""
    with span("cotr.squad.form"):
        live = [pi for pi, active in enumerate(actives) if active.any()]
        bf, bt, ids, q, counts, st = zip(*(
            _pair_tables(pairs[pi], actives[pi], zoom, max_load, safe_area)
            for pi in live))
        squads_of = [len(b) for b in bf]
        m_cap = max(i.shape[1] for i in ids)
        table_f, table_t, counts_all = map(np.concatenate, (bf, bt, counts))
        pair_of = np.repeat(np.asarray(live, np.int32), squads_of)
        # the target patch size a prediction is scaled by: the one-pair
        # route scales in float32 (as by a Python float), the multi-pair
        # route in float64, each as in its JAX twin
        size_t = np.repeat(np.asarray(
            st, np.float64 if indexed else np.float32), squads_of)
        ids_all = np.full((len(counts_all), m_cap), -1, int)
        q_all = np.zeros((len(counts_all), m_cap, 2), np.float32)
        for at, i, x in zip(np.cumsum([0] + squads_of), ids, q):
            ids_all[at:at + len(i), :i.shape[1]] = i
            q_all[at:at + len(i), :x.shape[1]] = x

    # dispatch every chunk first (device queue), read afterwards
    inflight = []
    squads = np.arange(len(counts_all))
    for sel, g_pad, m_pad in _chunk_plan(
            counts_all, max_load, group_bucket, member_bucket, group_cap,
            member_ladder, by_load=member_ladder and not indexed):
        chunk = squads[sel]
        gc = len(chunk)
        queries = np.zeros((g_pad, m_pad, 2), np.float32)
        member_ids = np.full((g_pad, m_pad), -1, int)
        mc = min(m_cap, m_pad)
        queries[:gc, :mc] = q_all[sel, :mc]
        member_ids[:gc, :mc] = ids_all[sel, :mc]
        boxes_from = np.zeros((g_pad, 4), np.float32)
        boxes_to = np.zeros((g_pad, 4), np.float32)
        idx = np.zeros(g_pad, np.int32)
        boxes_from[:gc], boxes_to[:gc] = table_f[sel], table_t[sel]
        idx[:gc] = pair_of[sel]
        # padding boxes take the chunk's largest patch size at (0, 0) of
        # pair 0, so one window covers the whole call; their results are
        # ignored
        boxes_from[gc:, 2:] = table_f[sel, 2].max()
        boxes_to[gc:, 2:] = table_t[sel, 2].max()
        if indexed:
            preds = stepper.dispatch_indexed(imgs_a, imgs_b, idx, boxes_from,
                                             boxes_to, queries)
        else:
            # fake steppers in tests may only implement __call__ (sync)
            preds = getattr(stepper, "dispatch", stepper)(
                imgs_a, imgs_b, boxes_from, boxes_to, queries)
        inflight.append((preds, member_ids[:gc], chunk))

    for preds, member_ids, chunk in inflight:
        rows, cols = np.nonzero(member_ids >= 0)
        # a device tensor's copy to the host is where the host waits
        preds = (preds.cpu().numpy() if torch.is_tensor(preds)
                 else np.asarray(preds))[rows, cols]
        squad, task = chunk[rows], member_ids[rows, cols]
        # back through each squad's target patch, vectorized
        size = size_t[squad]
        new_x = (preds[:, 0] - 0.5) * 2 * size + table_t[squad, 0]
        new_y = preds[:, 1] * size + table_t[squad, 1]
        owner = pair_of[squad]
        for pi in np.unique(owner):
            hit = owner == pi
            pairs[pi]["loc_to"][task[hit], 0] = new_x[hit]
            pairs[pi]["loc_to"][task[hit], 1] = new_y[hit]


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


def _refine(stepper, imgs_a, imgs_b, pairs, zoom_ins, converge_iters,
            indexed, **grouping) -> list:
    """Zoom-major squad refinement of every pair: one (len(zoom_ins), T_p,
    2) loc_to history per pair, the final row converged."""
    with span("cotr.squad.refine"):
        pairs = [dict(p, loc_from=np.asarray(p["loc_from"], np.float64),
                      loc_to=np.array(p["loc_to"], np.float64))
                 for p in pairs]
        histories: list = [[] for _ in pairs]
        for zi, zoom in enumerate(zoom_ins):
            is_final = zi == len(zoom_ins) - 1
            iters = converge_iters if is_final else 1
            actives = [np.ones(len(p["loc_from"]), bool) for p in pairs]
            zoom_hists = [np.zeros((iters, len(p["loc_from"]), 2))
                          for p in pairs]
            for it in range(iters):
                if not any(a.any() for a in actives):
                    break
                _zoom_level(stepper, imgs_a, imgs_b, pairs, actives, zoom,
                            indexed, **grouping)
                if not is_final:
                    break
                for pi, pair in enumerate(pairs):
                    actives[pi] = _settle_final_zoom(
                        pair["loc_to"], zoom_hists[pi], actives[pi], it,
                        iters)
            for history, pair in zip(histories, pairs):
                history.append(pair["loc_to"].copy())
        return [np.stack(h, axis=0) for h in histories]


def refine_grouped(runner, stepper: GroupedStepper, img_a_dev, hw_a,
                   img_b_dev, hw_b,
                   loc_from: np.ndarray, loc_to0: np.ndarray,
                   s_from: float, s_to: float, zoom_ins: Sequence[float],
                   rng: np.random.RandomState, converge_iters: int = 1,
                   max_load: int = 256, group_bucket: int = 8,
                   member_bucket: int = 64, group_cap: int = 128,
                   safe_area: float = SAFE_AREA,
                   member_ladder: bool = False) -> np.ndarray:
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
    pair = dict(hw_a=hw_a, hw_b=hw_b, s_from=s_from, s_to=s_to,
                loc_from=loc_from, loc_to=loc_to0, rng=rng)
    return _refine(stepper, img_a_dev, img_b_dev, [pair], zoom_ins,
                   converge_iters, indexed=False, max_load=max_load,
                   group_bucket=group_bucket, member_bucket=member_bucket,
                   group_cap=group_cap, safe_area=safe_area,
                   member_ladder=member_ladder)[0]


def refine_grouped_pairs(stepper: GroupedStepper, imgs_a_dev, imgs_b_dev,
                         pairs: Sequence[dict], zoom_ins: Sequence[float],
                         converge_iters: int = 1, max_load: int = 256,
                         group_bucket: int = 8, member_bucket: int = 64,
                         group_cap: int = 128, safe_area: float = SAFE_AREA,
                         member_ladder: bool = False) -> list:
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
    return _refine(stepper, imgs_a_dev, imgs_b_dev, pairs, zoom_ins,
                   converge_iters, indexed=True, max_load=max_load,
                   group_bucket=group_bucket, member_bucket=member_bucket,
                   group_cap=group_cap, safe_area=safe_area,
                   member_ladder=member_ladder)
