"""Make ``data/fr1_room_voc.npz``, the fr1_room configuration's vocabulary, on
the card: the port's scene vocabulary (k 10, L 6, ORBvoc's shape) of the
kfdense room orbit (room scene, seed 7, 240 frames), trained by
``vo_slam_test_tpu_torch.datasets.staging.scene_vocabulary`` on the host
extractor's descriptors of every fourth frame, as the reference trains a
scene vocabulary before it runs (map.cpp:60-99).

    python3 -m slambench.make_vocabulary

It prints the file's sha256 and size, which ``configs/fr1_room.json``
records and every run checks. The benchmark never runs this: the file is
made once and committed.
"""

from __future__ import annotations

import hashlib
import os
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parent / "data" / "fr1_room_voc.npz"


def main() -> int:
    os.environ["VO_STAGE_CACHE"] = str(Path(__file__).resolve().parent / ".cache" / "stage")
    import torch

    from vo_slam_test_tpu_torch import bench
    from vo_slam_test_tpu_torch.datasets import staging

    if not torch.cuda.is_available():
        print("make_vocabulary: the vocabulary is trained on the card's descriptors; no card",
              file=sys.stderr)
        return 2
    seq, cfg = bench.kfdense_sequence()
    tag = f"orbit{bench.KFDENSE_LOOPS}"
    grays, depths, _ = staging.render_all(seq, bench.KFDENSE_FRAMES, tag)
    voc = staging.scene_vocabulary(cfg, grays, depths, f"{tag}_{bench.KFDENSE_FRAMES}",
                                   device=torch.device("cuda"))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    voc.save(str(OUT))
    data = OUT.read_bytes()
    print(f"{OUT.name} sha256 {hashlib.sha256(data).hexdigest()} bytes {len(data)} "
          f"valid words {int(voc.node_valid[-1].sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
