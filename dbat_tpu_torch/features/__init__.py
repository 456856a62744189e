"""Feature detection + matching front-end (counterpart of
dbat_tpu/features).

  detect.py   batched blob/corner detection (separable Gaussian
              filtering + NMS + top-k + subpixel refinement) on the
              device
  describe.py batched patch descriptors (bilinear grid sampling)
  match.py    pairwise descriptor matching (one matmul per pair,
              mutual-NN + Lowe ratio)
  tracks.py   host-side union-find track building and Project assembly
  render.py   synthetic coded-target image renderer (test/demo data)
  pipeline.py images -> measured network (Project), ready for
              pose-graph init + bundle; load_images (PNG without
              matplotlib, io/png.py)
"""

from .detect import detect_blobs, detect_corners
from .describe import describe
from .match import match_pair, match_all_pairs
from .tracks import build_tracks, project_from_tracks
from .pipeline import network_from_images

__all__ = [
    "detect_blobs", "detect_corners", "describe", "match_pair",
    "match_all_pairs", "build_tracks", "project_from_tracks",
    "network_from_images",
]
