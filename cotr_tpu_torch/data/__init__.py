"""Training data on the host (counterpart of cotr_tpu/data): the synthetic
homography dataset, the MegaDepth datasets (``colmap``, ``scenes``,
``megadepth``, ``dataset``, ``device_synth``), the prefetching loader and
the sample helpers. Samples and batches are numpy dicts; ``Trainer``
uploads them."""

from cotr_tpu_torch.data.colmap import (ColmapAsciiReader,
                                        ColmapWithDepthAsciiReader,
                                        image_path_to_depth_path,
                                        read_cameras_txt, read_images_meta,
                                        read_points3d_txt, read_valid_list)
from cotr_tpu_torch.data.dataset import (CotrDataset, CotrZoomDataset,
                                         batch_iterator, compute_corrs)
from cotr_tpu_torch.data.megadepth import DataConfig, MegadepthDataset
from cotr_tpu_torch.data.scenes import ReprojRatioKnnSearch, SfmScene

__all__ = [
    "ColmapAsciiReader", "ColmapWithDepthAsciiReader",
    "image_path_to_depth_path", "read_cameras_txt", "read_images_meta",
    "read_points3d_txt", "read_valid_list", "CotrDataset", "CotrZoomDataset",
    "batch_iterator", "compute_corrs", "DataConfig", "MegadepthDataset",
    "ReprojRatioKnnSearch", "SfmScene",
]
