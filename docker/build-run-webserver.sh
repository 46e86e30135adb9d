#!/usr/bin/env bash
# Build and run the dashboard container over the detection container's data
# mount (reference docker/build-run-webserver.sh behavior, including the
# guard that the detection mount exists first).
set -euo pipefail

DATA_DIR="${DATA_DIR:-$HOME/meteor-data}"

if [[ ! -d "$DATA_DIR/csv-out" ]]; then
    echo "ERROR: $DATA_DIR/csv-out not found — start the detection container first" >&2
    exit 1
fi

docker build -f docker/Dockerfile-Webserver -t ms-web .
docker rm -f ms-web 2>/dev/null || true
docker run -d --name ms-web \
    --restart=always \
    -p 5000:5000 \
    -v "$DATA_DIR":/data \
    ms-web
echo "dashboard on http://localhost:5000/"
