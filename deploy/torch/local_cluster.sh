#!/usr/bin/env bash
# Runnable local cluster of ballista_tpu_torch: the scheduler (`serve`
# with its RPC wire) + N executor workers as separate processes on this
# host, then a smoke query over the wire through the CLI (twin of
# deploy/local_cluster.sh, which starts the TPU package). The process-level
# analog of docker-compose.yml, runnable without docker.
#
#   deploy/torch/local_cluster.sh [n_workers] [pull|push]
#
# BALLISTA_CLUSTER_DEVICE (default cuda) is every process's device: the
# executors' partitions, the scheduler's in-process executor and the
# planning contexts; cpu runs it all on the CPU. BALLISTA_CLUSTER_PORT sets
# the scheduler's RPC port (default: a random one in 20000-39999).
set -euo pipefail
cd "$(dirname "$0")/../.."

WORKERS="${1:-2}"
POLICY="${2:-push}"
DEVICE="${BALLISTA_CLUSTER_DEVICE:-cuda}"
PORT="${BALLISTA_CLUSTER_PORT:-$((20000 + RANDOM % 20000))}"
WORK_DIR="$(mktemp -d "${TMPDIR:-/tmp}/ballista_cluster.XXXX")"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"

PIDS=()
cleanup() {
  for pid in "${PIDS[@]}"; do kill "$pid" 2>/dev/null || true; done
  wait 2>/dev/null || true
  rm -rf "$WORK_DIR"
}
trap cleanup EXIT

# wait_for FILE TEXT SECONDS: until FILE holds TEXT
wait_for() {
  for _ in $(seq 1 $((10 * $3))); do
    if grep -q "$2" "$1" 2>/dev/null; then return 0; fi
    sleep 0.1
  done
  echo "timed out waiting for '$2' in $1:" >&2
  tail -20 "$1" >&2
  return 1
}

python -m ballista_tpu_torch.serve --host 127.0.0.1 --port 0 \
  --scheduler-rpc-port "$PORT" --policy "$POLICY" \
  --work-dir "$WORK_DIR/shuffle" --device "$DEVICE" \
  > "$WORK_DIR/scheduler.log" 2>&1 &
PIDS+=($!)
wait_for "$WORK_DIR/scheduler.log" "scheduler RPC wire on" 120

for i in $(seq 1 "$WORKERS"); do
  python -m ballista_tpu_torch.scheduler.executor_process \
    --scheduler "http://127.0.0.1:$PORT" --executor-id "local-$i" \
    --device "$DEVICE" --partitions 4 --policy "$POLICY" --heartbeat-s 2 \
    > "$WORK_DIR/executor-$i.log" 2>&1 &
  PIDS+=($!)
done
for i in $(seq 1 "$WORKERS"); do
  wait_for "$WORK_DIR/executor-$i.log" "EXECUTOR_READY" 120
done

OUT="$(python -m ballista_tpu_torch.cli --connect "http://127.0.0.1:$PORT" \
  --sf 0.01 --device "$DEVICE" --format csv \
  -c "select o_orderpriority, count(*) n from orders join customer on o_custkey = c_custkey group by o_orderpriority order by o_orderpriority")"
echo "$OUT"
# a header and the five order priorities, each with orders
ROWS="$(echo "$OUT" | grep -cE '^[1-5]-[A-Z ]+,[1-9][0-9]*$' || true)"
if [ "$ROWS" != 5 ]; then
  echo "expected 5 priorities with orders, got $ROWS" >&2
  exit 1
fi
echo "CLUSTER_SMOKE_OK"
