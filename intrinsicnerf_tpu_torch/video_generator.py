"""Batch PNG -> mp4 conversion of a render directory.

The port's twin of ``video_generator.py``: every modality of
``--img_dir`` (``rgb_000.png``..., the decomposition, cluster and edit
frames) becomes one mp4 (``tools/video.py:generate_all``).

    python -m intrinsicnerf_tpu_torch.video_generator --img_dir logs/x/train_render/step_200000 [--fps 30]
"""

from __future__ import annotations

import argparse

from intrinsicnerf_tpu_torch.tools.video import generate_all


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--fps", type=int, default=30)
    args = parser.parse_args(argv)
    written = generate_all(args.img_dir, args.out_dir, args.fps)
    for w in written:
        print("wrote", w)
    if not written:
        print("no recognized frame sequences found")
    return written


if __name__ == "__main__":
    main()
