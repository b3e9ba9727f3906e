#!/usr/bin/env bash
# The PyTorch port's launcher for GHOST(+BUSCA): the flag surface of the
# reference's scripts/run_ghost.sh over busca_tpu_torch.eval.run.
TRACKER_NAME="GHOST"
TRACKER_FLAG="ghost"
DETECTOR_FLAGS=""
source "$(dirname "${BASH_SOURCE[0]}")/_run_common_torch.sh"
