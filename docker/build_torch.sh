#!/usr/bin/env bash
# Build the PyTorch port's CUDA image (Dockerfile.cuda; BuildKit reads
# Dockerfile.cuda.dockerignore beside it).  No GPU is needed to build.
#   ./docker/build_torch.sh
set -euo pipefail
cd "$(dirname "$0")/.."
TAG=${TAG:-busca-tpu-torch}
DOCKER_BUILDKIT=1 docker build -f Dockerfile.cuda -t "$TAG" .
