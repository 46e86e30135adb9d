#!/usr/bin/env bash
# Build and run the detection container with restart-on-crash supervision
# (reference docker/build-run-detection.sh behavior).
set -euo pipefail

DATA_DIR="${DATA_DIR:-$HOME/meteor-data}"
STREAM_URL="${STREAM_URL:?set STREAM_URL to the audio stream to monitor}"

mkdir -p "$DATA_DIR/csv-out" "$DATA_DIR/spec-out"

docker build -f docker/Dockerfile-Detection -t ms-detect .
docker rm -f ms-detect 2>/dev/null || true
docker run -d --name ms-detect \
    --restart=always \
    -e STREAM_URL="$STREAM_URL" \
    -v "$DATA_DIR":/data \
    ms-detect
echo "detection container running; ledger at $DATA_DIR/csv-out"
