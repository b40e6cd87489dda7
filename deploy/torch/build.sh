#!/bin/sh
# Build the port's two images (ref: deploy/build.sh, docker/build.sh). Run
# from the repo root; the trainer image needs network access for its base
# image and wheels, not a card.
set -e
TAG="${TAG:-latest}"
docker build -f deploy/torch/Dockerfile.controller -t "edl-tpu-torch-controller:${TAG}" .
docker build -f deploy/torch/Dockerfile.trainer -t "edl-tpu-torch:${TAG}" .
echo "built edl-tpu-torch-controller:${TAG} and edl-tpu-torch:${TAG}"
