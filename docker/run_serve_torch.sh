#!/usr/bin/env bash
# Run the port's serving container on the host's GPUs: unix socket shared
# via a bind mount, weights mounted read-only (read as they are, no
# conversion step).
#   WEIGHTS=/path/to/weights ./docker/run_serve_torch.sh --detector yolox-x \
#       --detector-ckpt /weights/bytetrack_x_mot17.pth.tar
set -euo pipefail
TAG=${TAG:-busca-tpu-torch}
SOCK_DIR=${SOCK_DIR:-/tmp/busca-serve}
WEIGHTS=${WEIGHTS:-$PWD/weights}
mkdir -p "$SOCK_DIR"
exec docker run --rm -it \
  ${GPU_FLAGS:---gpus all} \
  -v "$SOCK_DIR":/sock \
  -v "$WEIGHTS":/weights:ro \
  "$TAG" --socket /sock/busca.sock "$@"
