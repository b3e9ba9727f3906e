"""Serving (port of ``busca_tpu.serve``): the tracking server over a unix
socket (:mod:`busca_tpu_torch.serve.server`), the lockstep server that
batches concurrent streams (:mod:`busca_tpu_torch.serve.lockstep`), tracker
snapshot and restore (:mod:`busca_tpu_torch.serve.snapshot`), and
ahead-of-time ``torch.export`` artifacts of the detector step and the
association scorer (:mod:`busca_tpu_torch.serve.export`) with the
detectors that run them (:mod:`busca_tpu_torch.serve.detector`): the
counterpart of the reference's TensorRT deployment path
(adapters/ByteTrack/tools/track.py:83,215-224)."""

from busca_tpu_torch.serve.detector import (  # noqa: F401
    ArtifactBatchDetector,
    ArtifactDetector,
)
from busca_tpu_torch.serve.export import (  # noqa: F401
    ExportedArtifact,
    export_associate_scorer,
    export_detector_batch_steps,
    export_detector_step,
    load_artifact,
    load_batch_artifacts,
)
from busca_tpu_torch.serve.lockstep import LockstepTrackingServer  # noqa: F401
from busca_tpu_torch.serve.server import (  # noqa: F401
    TrackingClient,
    TrackingServer,
)
