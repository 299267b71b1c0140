"""SfmScene container and depth-reprojection kNN retrieval (a copy of
cotr_tpu/data/scenes.py)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from cotr_tpu_torch.utils.constants import VALID_NN_OVERLAPPING_THRESH


class SfmScene:
    """Capture list + path/id/fname -> index lookups."""

    def __init__(self, captures: List, point_cloud: Optional[np.ndarray] = None,
                 point_meta: Optional[Dict[int, np.ndarray]] = None):
        self.captures = captures
        self.point_cloud = point_cloud
        # {point3d_id: observing image ids} for covisibility lookups
        self.point_meta = point_meta
        self.img_path_to_index_dict: Dict[str, int] = {}
        self.img_id_to_index_dict: Dict[int, int] = {}
        self.fname_to_index_dict: Dict[str, int] = {}
        for i, cap in enumerate(captures):
            fname = os.path.basename(cap.img_path)
            if cap.img_path in self.img_path_to_index_dict \
                    or fname in self.fname_to_index_dict:
                raise ValueError(f"two captures of {cap.img_path}")
            self.img_path_to_index_dict[cap.img_path] = i
            self.fname_to_index_dict[fname] = i
            if hasattr(cap, "image_id"):
                self.img_id_to_index_dict[cap.image_id] = i

    def __len__(self):
        return len(self.captures)

    def __getitem__(self, x):
        if isinstance(x, str):
            if x in self.img_path_to_index_dict:
                return self.captures[self.img_path_to_index_dict[x]]
            return self.captures[self.fname_to_index_dict[x]]
        return self.captures[x]

    def get_captures_given_index_list(self, index_list):
        return [self.captures[i] for i in index_list]

    def get_covisible_caps(self, cap) -> List:
        """Captures sharing at least one 3D point with ``cap``. Requires the
        scene to be read with ``covisibility=True`` so captures carry
        ``point3d_id`` and the scene carries ``point_meta``."""
        if cap.img_path not in self.img_path_to_index_dict:
            raise KeyError(f"{cap.img_path} is not in this scene")
        if self.point_meta is None:
            raise ValueError("scene was not read with covisibility=True")
        covis_img_id = set()
        for pid in cap.point3d_id:
            # real COLMAP exports can reference a POINT3D_ID in images.txt
            # that was filtered out of points3D.txt; skip those points
            meta = self.point_meta.get(int(pid))
            if meta is not None:
                covis_img_id.update(meta.tolist())
        return [self.captures[self.img_id_to_index_dict[i]]
                for i in sorted(covis_img_id)
                if i in self.img_id_to_index_dict]

    def read_data_to_ram(self, data_list) -> float:
        """Bulk preload; returns MB loaded."""
        total = 0
        for cap in self.captures:
            if "image" in data_list:
                total += cap.read_image_to_ram()
            if "depth" in data_list:
                total += cap.read_depth_to_ram()
        return total / (1024.0 * 1024.0)


class ReprojRatioKnnSearch:
    """kNN retrieval over a precomputed NxN depth-reprojection-overlap matrix
    (``dist_mat/dist_mat.npy`` beside the scene's depth directory, as
    scripts/prepare_nn_distance_mat.py writes it)."""

    def __init__(self, scene: SfmScene,
                 dist_mat_path: Optional[str] = None):
        self.scene = scene
        if dist_mat_path is None:
            dist_mat_path = os.path.join(
                os.path.dirname(os.path.dirname(
                    scene.captures[0].depth_path)),
                "dist_mat/dist_mat.npy")
        self.distance_mat = np.load(dist_mat_path)
        self.nn_index = (-1 * self.distance_mat).argsort(axis=1)

    def get_knn(self, query, k: int, db_mask: Optional[np.ndarray] = None):
        query_index = self.scene.img_path_to_index_dict[query.img_path]
        row = self.distance_mat[query_index]
        if db_mask is not None:
            query_mask = np.setdiff1d(np.arange(row.shape[0]), db_mask)
            num_pos = (row[db_mask] > VALID_NN_OVERLAPPING_THRESH).sum()
        else:
            query_mask = None
            num_pos = (row > VALID_NN_OVERLAPPING_THRESH).sum()

        def masked_order(n):
            tmp = row.copy()
            tmp[query_mask] = -1
            return (-1 * tmp).argsort(axis=0)[:n]

        if num_pos > k:
            ind = (self.nn_index[query_index][:k + 1] if db_mask is None
                   else masked_order(k + 1))
            if query_index in ind:
                ind = np.delete(ind, np.argwhere(ind == query_index))
            else:
                ind = ind[:k]
        else:
            k = int(num_pos)
            ind = (self.nn_index[query_index][:max(k, 1)] if db_mask is None
                   else masked_order(max(k, 1)))
        return self.scene.get_captures_given_index_list(ind)
