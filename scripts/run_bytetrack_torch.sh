#!/usr/bin/env bash
# The PyTorch port's launcher for ByteTrack(+BUSCA): the flag surface of the
# reference's scripts/run_bytetrack.sh over busca_tpu_torch.eval.run.
TRACKER_NAME="ByteTrack"
TRACKER_FLAG="byte"
DETECTOR_FLAGS="--detector yolox-x"
source "$(dirname "${BASH_SOURCE[0]}")/_run_common_torch.sh"
