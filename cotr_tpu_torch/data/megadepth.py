"""MegaDepth scene multiplexer (counterpart of cotr_tpu/data/megadepth.py):
a process-level scene cache (so loader workers share parsed scenes),
query/db capture sets from train/val/test split JSONs, and kNN neighbour
sampling. It draws from its ``random.Random`` exactly as the JAX package
does, so the same seed gives the same pairs."""

from __future__ import annotations

import dataclasses
import json
import os
import random
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from cotr_tpu_torch.data.colmap import ColmapWithDepthAsciiReader
from cotr_tpu_torch.data.scenes import ReprojRatioKnnSearch, SfmScene


class SceneCapIndex(NamedTuple):
    scene_index: int
    capture_index: int


@dataclasses.dataclass
class DataConfig:
    """Dataset options."""

    scenes_name_list: List[Dict[str, str]] = dataclasses.field(
        default_factory=list)  # dicts with scene_dir/image_dir/depth_dir
    valid_list_json: str = ""
    train_json: str = ""
    val_json: str = ""
    test_json: str = ""
    crop_cam: str = "crop_center_and_resize"
    use_ram: bool = False
    pool_size: int = 20
    k_size: int = 1
    num_kp: int = 100
    kp_pool: int = 100
    bidirectional: bool = True
    need_rotation: bool = False
    max_rotation: float = 0.0
    rotation_chance: float = 0.0
    # zoom dataset (options for stage 3)
    zoom_start: float = 1.0
    zoom_end: float = 0.1
    zoom_levels: int = 10
    zoom_jitter: float = 0.5

    def split_json(self, dataset_type: str) -> str:
        return {"train": self.train_json, "val": self.val_json,
                "test": self.test_json}[dataset_type]


def prefix_of_img_path(img_path: str) -> str:
    """Dataset root = 4 levels above an image file."""
    return os.path.abspath(os.path.join(img_path, "../../../..")) + "/"


class _SceneCache:
    """Class-level cache shared across dataset instances / loader workers.
    A scene is cached under its directory and the options it was read with
    (the JAX package's key is the directory alone, so there a second crop
    of the same scene gets the first one's captures)."""

    scenes: Dict[tuple, SfmScene] = {}
    knn: Dict[tuple, ReprojRatioKnnSearch] = {}

    @classmethod
    def load(cls, cfg: DataConfig, scene_dir_dict: Dict[str, str]):
        key = (scene_dir_dict["scene_dir"], scene_dir_dict["image_dir"],
               scene_dir_dict["depth_dir"], cfg.valid_list_json,
               str(cfg.crop_cam), cfg.use_ram)
        if key not in cls.scenes:
            scene = ColmapWithDepthAsciiReader.read_sfm_scene_given_valid_list_path(
                scene_dir_dict["scene_dir"], scene_dir_dict["image_dir"],
                scene_dir_dict["depth_dir"], cfg.valid_list_json, cfg.crop_cam)
            if cfg.use_ram:
                scene.read_data_to_ram(["image", "depth"])
            cls.scenes[key] = scene
            cls.knn[key] = ReprojRatioKnnSearch(scene)
        return cls.scenes[key], cls.knn[key]


class MegadepthDataset:
    def __init__(self, cfg: DataConfig, dataset_type: str,
                 rng: Optional[random.Random] = None):
        if dataset_type not in ("train", "val", "test"):
            raise ValueError(f"dataset_type {dataset_type!r}")
        if not cfg.scenes_name_list:
            raise ValueError("DataConfig.scenes_name_list is empty")
        self.cfg = cfg
        self.dataset_type = dataset_type
        self.rng = rng or random.Random(0)
        self.scenes: List[SfmScene] = []
        self.knn_engines: List[ReprojRatioKnnSearch] = []
        self.img_path_to_scene_cap_index: Dict[str, SceneCapIndex] = {}
        self.scene_index_to_db_caps_mask: Dict[int, np.ndarray] = {}
        self._load_scenes()

    def _common_subset(self, json_path: str, total_caps) -> set:
        prefix = prefix_of_img_path(list(total_caps)[0])
        with open(json_path) as f:
            common = [prefix + cap for cap in json.load(f)]
        return set(total_caps) & set(common)

    def _load_scenes(self):
        total_caps = set()
        for scene_id, sdd in enumerate(self.cfg.scenes_name_list):
            scene, knn = _SceneCache.load(self.cfg, sdd)
            total_caps |= set(scene.img_path_to_index_dict.keys())
            for path, idx in scene.img_path_to_index_dict.items():
                self.img_path_to_scene_cap_index[path] = SceneCapIndex(
                    scene_id, idx)
            self.scenes.append(scene)
            self.knn_engines.append(knn)
        self.query_caps_set = self._common_subset(
            self.cfg.split_json(self.dataset_type), total_caps)
        self.db_caps_set = self._common_subset(self.cfg.train_json, total_caps)
        for cap in self.db_caps_set:
            sid, cid = self.img_path_to_scene_cap_index[cap]
            self.scene_index_to_db_caps_mask.setdefault(sid, []).append(cid)
        for k in list(self.scene_index_to_db_caps_mask):
            self.scene_index_to_db_caps_mask[k] = np.array(
                sorted(self.scene_index_to_db_caps_mask[k]))
        self._sorted_queries = sorted(self.query_caps_set)

    @property
    def num_queries(self):
        return len(self.query_caps_set)

    def get_query_with_knn(self, index: int):
        """(query capture, [k sampled neighbors])."""
        img_path = self._sorted_queries[index]
        scene_index, cap_index = self.img_path_to_scene_cap_index[img_path]
        query_cap = self.scenes[scene_index].captures[cap_index]
        db_mask = self.scene_index_to_db_caps_mask.get(scene_index)
        pool = self.knn_engines[scene_index].get_knn(
            query_cap, self.cfg.pool_size, db_mask=db_mask)
        nn_caps = self.rng.sample(pool, min(len(pool), self.cfg.k_size))
        return query_cap, nn_caps
