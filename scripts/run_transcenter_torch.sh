#!/usr/bin/env bash
# The PyTorch port's launcher for TransCenter(+BUSCA): the flag surface of the
# reference's scripts/run_transcenter.sh over busca_tpu_torch.eval.run.
TRACKER_NAME="TransCenter"
TRACKER_FLAG="transcenter"
DETECTOR_FLAGS="--detector transcenter"
source "$(dirname "${BASH_SOURCE[0]}")/_run_common_torch.sh"
