"""Serving (port of ``busca_tpu.serve``'s sequential mode): the tracking
server over a unix socket (:mod:`busca_tpu_torch.serve.server`) and tracker
snapshot and restore (:mod:`busca_tpu_torch.serve.snapshot`).  The lockstep
server, ahead-of-time artifacts and their detector are ROADMAP.md items 20
and 21."""

from busca_tpu_torch.serve.server import (  # noqa: F401
    TrackingClient,
    TrackingServer,
)
