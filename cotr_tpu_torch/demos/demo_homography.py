"""Virtual-painting overlay via homography (counterpart of
demos/demo_homography.py): the reference's 4 hand-annotated corners of the
painting in frame A are matched into frame B with forced queries; the
replacement painting is then perspective-warped onto frame B on the card,
and the composite and the corner correspondences are written out.

    python -m cotr_tpu_torch.demos.demo_homography --img_a a.npy \\
        --img_b b.npy --rep_img painting.npy --out overlay.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from cotr_tpu_torch.demos.demo_utils import (SAMPLE_DIR, ZOOM_INS,
                                             add_common_args, build_engine,
                                             load_image,
                                             save_corr_visualization,
                                             write_png)
from cotr_tpu_torch.ops.geometry_cv import (homography_from_4pts,
                                            warp_perspective)
from cotr_tpu_torch.utils.device import resolve_device

# hand-annotated painting corners in paint_1.JPG (lu, ru, lb, rb)
ANNOTATED_CORNERS = np.array([[932, 1025], [2469, 901],
                              [908, 2927], [2436, 3080]], np.float32)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_common_args(ap)
    ap.add_argument("--img_a", default=f"{SAMPLE_DIR}/imgs/paint_1.JPG")
    ap.add_argument("--img_b", default=f"{SAMPLE_DIR}/imgs/paint_2.jpg")
    ap.add_argument("--rep_img",
                    default=f"{SAMPLE_DIR}/imgs/Meisje_met_de_parel.jpg",
                    help="painting to composite over the matched corners")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> dict:
    """Returns ``corrs`` (the four corners), ``homography``, ``warped``
    (the painting on B's grid, float32) and ``overlay`` (uint8)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    engine = build_engine(args, mode="stretching", device=dev)
    img_a = load_image(args.img_a)
    img_b = load_image(args.img_b)
    rep_img = load_image(args.rep_img)

    corrs = engine.cotr_corr_multiscale(
        img_a, img_b, zoom_ins=ZOOM_INS, converge_iters=1, max_corrs=4,
        queries_a=ANNOTATED_CORNERS.copy(), force=True)
    print("corner correspondences:\n", corrs)

    # replacement image corners -> matched corners in frame B
    rh, rw = rep_img.shape[:2]
    rep_coord = np.array([[0, 0], [rw, 0], [0, rh], [rw, rh]], np.float32)
    hmat = homography_from_4pts(rep_coord, corrs[:, 2:].astype(np.float32))
    print("homography:\n", hmat)

    out_hw = img_b.shape[:2]
    warped = warp_perspective(torch.from_numpy(rep_img).to(dev), hmat,
                              out_hw)
    vmask = warp_perspective(torch.ones(rep_img.shape[:2] + (1,),
                                        device=dev), hmat, out_hw) > 0
    overlay = (warped * vmask + torch.from_numpy(img_b).to(dev) * ~vmask
               ).to(torch.uint8).cpu().numpy()

    out_path = args.out or "homography_output.png"
    write_png(out_path, overlay)
    print(f"painted overlay -> {out_path}")
    save_corr_visualization(img_a, img_b, corrs,
                            out_path.replace(".png", "_corrs.png"))
    return {"corrs": corrs, "homography": hmat,
            "warped": warped.cpu().numpy(), "overlay": overlay}


if __name__ == "__main__":
    main()
