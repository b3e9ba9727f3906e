"""busca_tpu_torch — the PyTorch + CUDA port of busca_tpu for NVIDIA Hopper.

The canonical ByteTrack + BUSCA loop and its live detectors, module for
module beside the JAX package it is diffed against:

- ``ops``      — the crop-resize op (plain torch, and the CUDA kernel K1 in
  ``csrc/crop_resize.cu``), the local tap sum (K2 in
  ``csrc/local_tap_sum.cu``), NMS and the YOLOX postprocess, host LAPJV
- ``models``   — GHOST ReID ResNet-50, decision Transformer, 3-D positional
  encodings, YOLOX, TransCenter, the flax -> torch weight bridge
- ``assoc``    — the association engine and the device crop bank
- ``core``     — host (numpy) geometry and Kalman math
- ``trackers`` — the BYTE strategy with the BUSCA third round
- ``eval``     — synthetic sequences, MOT IO and frame loader, CLEAR/IDF1/
  HOTA, the runner, the live detector loops, the CLI, the metric sum
  across processes
- ``serve``    — the tracking server over a unix socket and tracker
  snapshot/restore
- ``train``    — training episodes (synthetic and MOT-gt, cropped through
  K1), the train step with optax's AdamW, the full-loop demo
- ``config``   — reference-YAML config loading
- ``parallel`` — the (dp, tp) mesh over ``torch.distributed``: sharding
  rules, the sharded model's collectives, multi-rank launches
- ``viz``      — track boxes and the decision montage
- ``utils``    — device resolution, memory, stage timing and tracing, the
  file sampler

The package imports torch, numpy and scipy, and cv2 only where frames are
decoded, aligned or drawn.  Entry points take a
``device`` that defaults to ``"cuda"`` and raise when CUDA is absent unless
the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
