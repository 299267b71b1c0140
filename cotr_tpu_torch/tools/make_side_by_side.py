"""Side-by-side pictures of the demo twins' outputs and the reference's
expected outputs (counterpart of tools/make_side_by_side.py).

Each composite is our golden and the reference's output, each resized to a
height of 360 with PIL's BILINEAR rule (``ops/sampling.resize_pil_host``,
equal to PIL's) under a 22-row bar, with an 8-column white gap between
them. The card's machine has no PIL to draw text, so the bars stay plain
(24, 24, 24) and each side's label goes into the PNG's ``tEXt`` chunks
("Label left", "Label right"). A pair whose files are absent is skipped.
The composites are qualitative: the weights differ.

  python -m cotr_tpu_torch.tools.make_side_by_side \\
      [--ours tests/golden/torch_demos --ref REF_IMGS --out out/side_by_side]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from cotr_tpu_torch.demos.demo_utils import SAMPLE_DIR

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# our golden -> reference expected output (reference readme.md:78-134)
PAIRS = [
    ("demo_single_pair.png", "sparse_output.png", "demo_single_pair"),
    ("demo_face.png", "face_output.png", "demo_face"),
    ("demo_homography.png", "paint_output.png", "demo_homography"),
    ("demo_guided_matching.png", "guided_matching_output.png",
     "demo_guided_matching"),
    ("demo_reconstruction.png", "recon_output.png", "demo_reconstruction"),
]

HEIGHT = 360
BAR_ROWS = 22
BAR_RGB = (24, 24, 24)
GAP_COLUMNS = 8


def labeled(img: np.ndarray, height: int = HEIGHT) -> np.ndarray:
    """``img`` (any of read_png's layouts) as RGB at ``height`` rows,
    width in proportion, under a plain bar: (height + BAR_ROWS, w, 3)."""
    from cotr_tpu_torch.demos.demo_utils import to_rgb
    from cotr_tpu_torch.ops.sampling import resize_pil_host

    w = int(round(img.shape[1] * height / img.shape[0]))
    img = resize_pil_host(to_rgb(img), (height, w))
    bar = np.empty((BAR_ROWS, w, 3), np.uint8)
    bar[:] = BAR_RGB
    return np.concatenate([bar, img], axis=0)


def composite(ours: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Ours left, the reference right, a white gap between."""
    left, right = labeled(ours), labeled(ref)
    gap = np.full((HEIGHT + BAR_ROWS, GAP_COLUMNS, 3), 255, np.uint8)
    return np.concatenate([left, gap, right], axis=1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ours", default=os.path.join(REPO, "tests", "golden",
                                                   "torch_demos"))
    ap.add_argument("--ref", default=os.path.join(SAMPLE_DIR, "imgs"))
    ap.add_argument("--out", default=os.path.join(REPO, "out",
                                                  "side_by_side"))
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Write the composites; returns their paths. Host only."""
    from cotr_tpu_torch.demos.demo_utils import read_png, write_png

    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    made = []
    for ours_name, ref_name, title in PAIRS:
        op = os.path.join(args.ours, ours_name)
        rp = os.path.join(args.ref, ref_name)
        if not (os.path.exists(op) and os.path.exists(rp)):
            print(f"skip {title}: missing "
                  f"{op if not os.path.exists(op) else rp}")
            continue
        out_path = os.path.join(args.out, f"{title}.png")
        write_png(out_path, composite(read_png(op), read_png(rp)), text={
            "Label left": f"{title} - ours (from-scratch flagship)",
            "Label right": f"{title} - reference (released checkpoint)"})
        made.append(out_path)
        print(f"wrote {out_path}")
    print(f"{len(made)} composites")
    return made


if __name__ == "__main__":
    main()
