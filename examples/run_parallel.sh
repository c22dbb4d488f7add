#!/usr/bin/env bash
# Multi-card launch rehearsal (reference: example/run_parallel.sh).
#
# The reference launches torchrun --nproc_per_node=2 with xDiT degrees;
# here one process drives every card of the host through one mesh.  This
# script validates the sharded graph on a virtual CPU mesh; on the cards
# run examples/parallel_video.py directly (or chip_smoke.py --cards 4):
set -e
cd "$(dirname "$0")/.."

: "${DEVICES:=8}"
SAGE_CPU_DEVICES="${DEVICES}" \
python examples/parallel_video.py \
    --model cogvideox-2b \
    --ring_degree "${RING_DEGREE:-2}" \
    --ulysses_degree "${ULYSSES_DEGREE:-2}" \
    --cfg_parallel \
    --scale "${SCALE:-0.15}" \
    --smoke \
    "$@"
