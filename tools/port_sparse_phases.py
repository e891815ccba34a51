"""The sparse, spatial, image, indexing and random phases of
``chip_smoke.py`` alone, on one GPU:

    python3 tools/port_sparse_phases.py [--seed 0] [--phases sparse_mf,...]

``sparse_mf`` (the MF example at ml-10m's id ranges through
``gluon.Trainer``'s lazy row_sparse updates), ``sparse_linear`` (the
linear classification example over ``LibSVMIter`` CSR batches at the
avazu setting), ``wide_deep`` (examples/wide_deep.py through
``TrainStep``), ``fast_rcnn`` (Fast R-CNN's ROI head on VGG-16, then
examples/fast_rcnn_roi.py), ``spatial_ops`` (Correlation, the warp and
SpatialTransformer against the CPU), ``image_ops`` (the ``nd.image``
augmentations into a ResNet-50 v1 forward) and ``indexing_random_ops``
(gather/scatter_nd and the samplers), with the same checks and JSON
lines as in the whole smoke, after the ``device`` line, and each phase's
launch counts of the hand-written kernels.  B1 and B2 (for
``image_ops``) are built first.
"""
import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

PHASES = ("sparse_mf", "sparse_linear", "wide_deep", "fast_rcnn",
          "spatial_ops", "image_ops", "indexing_random_ops")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    smi = cs.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "image_ops" in phases:
        cs.phase_build(["sbr_matmul", "sbr_conv3x3"])
    launches = {}
    with tempfile.TemporaryDirectory(prefix="port_sparse_") as tmpdir:
        for name in phases:
            cs._zero_counts()
            if name == "sparse_linear":
                cs.phase_sparse_linear(args.seed, tmpdir)
            else:
                getattr(cs, "phase_" + name)(args.seed)
            launches[name] = cs._counts()
            torch.cuda.empty_cache()
    print(json.dumps({"launches_sparse_image": launches}), flush=True)
    print(smi or "nvidia-smi: not available", flush=True)


if __name__ == "__main__":
    main()
