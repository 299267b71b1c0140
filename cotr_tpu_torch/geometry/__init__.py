"""Camera geometry on the host (counterpart of cotr_tpu/geometry): pose and
intrinsics algebra, lazily read captures and their crops, point-cloud
(un)projection. numpy but for ``projector.project_points`` and
``projector.unproject_depth``, which are torch."""

from cotr_tpu_torch.geometry import transforms
from cotr_tpu_torch.geometry.camera import (CameraPose, PinholeCamera,
                                            Rotation, Translation,
                                            UnstableRotation,
                                            crop_pinhole_camera,
                                            inverse_camera_pose,
                                            rotate_camera_pose)
from cotr_tpu_torch.geometry.capture import (BasePinholeCapture,
                                             CapturedDepth, CapturedImage,
                                             CropCamConfig,
                                             DepthPinholeCapture,
                                             RGBDPinholeCapture,
                                             RGBPinholeCapture, crop_capture,
                                             crop_center_max, pad_to_square,
                                             read_colmap_array, read_image,
                                             resize_nearest_host,
                                             rotate_capture, rotate_image)
from cotr_tpu_torch.geometry.projector import (img_2d_to_pcd_2d,
                                               img_2d_to_pcd_3d,
                                               optical_flow_from_a_to_b,
                                               pcd_2d_to_img_2d,
                                               pcd_2d_to_pcd_3d,
                                               pcd_3d_to_pcd_2d,
                                               project_points,
                                               unproject_depth)

__all__ = [
    "transforms", "CameraPose", "PinholeCamera", "Rotation", "Translation",
    "UnstableRotation", "crop_pinhole_camera", "inverse_camera_pose",
    "rotate_camera_pose", "BasePinholeCapture", "CapturedDepth",
    "CapturedImage", "CropCamConfig", "DepthPinholeCapture",
    "RGBDPinholeCapture", "RGBPinholeCapture", "crop_capture",
    "crop_center_max", "pad_to_square", "read_colmap_array", "read_image",
    "resize_nearest_host", "rotate_capture", "rotate_image",
    "img_2d_to_pcd_2d", "img_2d_to_pcd_3d", "optical_flow_from_a_to_b",
    "pcd_2d_to_img_2d", "pcd_2d_to_pcd_3d", "pcd_3d_to_pcd_2d",
    "project_points", "unproject_depth",
]
