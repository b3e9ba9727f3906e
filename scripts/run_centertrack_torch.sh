#!/usr/bin/env bash
# The PyTorch port's launcher for CenterTrack(+BUSCA): the flag surface of the
# reference's scripts/run_centertrack.sh over busca_tpu_torch.eval.run.
TRACKER_NAME="CenterTrack"
TRACKER_FLAG="centertrack"
DETECTOR_FLAGS="--detector centertrack"
source "$(dirname "${BASH_SOURCE[0]}")/_run_common_torch.sh"
