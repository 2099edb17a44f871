#!/usr/bin/env bash
# Launch an N-process multi-host render locally (CPU backend, Gloo
# collectives) — the single-machine rehearsal of a multi-host launch,
# where each process would instead run on its own host with
# JAX_PLATFORMS unset (its GPUs) and the same --coordinator flags.
#
# Usage: scripts/launch_multihost.sh [NPROCS] [DEVS_PER_PROC] [extra render args...]
set -euo pipefail

NPROCS="${1:-2}"
DEVS="${2:-2}"
shift $(( $# >= 2 ? 2 : $# )) || true
PORT="${PT_COORD_PORT:-$((20000 + RANDOM % 20000))}"
OUT="${PT_OUT:-/tmp/pt_multihost}"
mkdir -p "$OUT"

pids=()
for (( p=0; p<NPROCS; p++ )); do
    JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=$DEVS" \
    python -m cpu_path_tracing_tpu.cli render \
        --coordinator "127.0.0.1:$PORT" --num-processes "$NPROCS" --process-id "$p" \
        --integrator batch \
        -o "$OUT/image.png" "$@" &
    pids+=($!)
done
rc=0
for pid in "${pids[@]}"; do wait "$pid" || rc=$?; done
exit $rc
