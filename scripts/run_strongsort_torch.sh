#!/usr/bin/env bash
# The PyTorch port's launcher for StrongSORT(+BUSCA): the flag surface of the
# reference's scripts/run_strongsort.sh over busca_tpu_torch.eval.run.
TRACKER_NAME="StrongSORT"
TRACKER_FLAG="strongsort"
DETECTOR_FLAGS=""
source "$(dirname "${BASH_SOURCE[0]}")/_run_common_torch.sh"
