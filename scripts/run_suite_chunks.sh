#!/bin/bash
# Run the CPU test suite in sequential chunks, each under its own timeout,
# so no single pytest invocation trips long-run limits. Usage:
#   bash scripts/run_suite_chunks.sh [extra pytest args]
set -u
cd "$(dirname "$0")/.."
export RTW_NO_CACHE=1 JAX_PLATFORMS=cpu
export XLA_FLAGS=--xla_force_host_platform_device_count=8

CHUNK1="tests/test_vecmath.py tests/test_sampling.py tests/test_camera.py \
tests/test_intersect.py tests/test_utils.py tests/test_xoroshiro.py \
tests/test_render.py tests/test_goldens.py tests/test_native_imageio.py \
tests/test_chip_smoke.py tests/test_gpu.py"
CHUNK2="tests/test_integrator.py tests/test_compaction.py \
tests/test_pallas_intersect.py tests/test_edge.py"
CHUNK3="tests/test_grad.py tests/test_tripwire.py tests/test_inverse.py"
CHUNK4="tests/test_parallel.py tests/test_multiprocess.py tests/test_elastic.py \
tests/test_round3_entry.py tests/test_checkpoint_sharded.py"

rc=0
for c in "$CHUNK1" "$CHUNK2" "$CHUNK3" "$CHUNK4"; do
  echo "=== chunk: $c"
  timeout 580 python -m pytest $c -q -p no:cacheprovider "$@" 2>&1 | tail -4
  s=${PIPESTATUS[0]}
  if [ "$s" -ne 0 ]; then rc=$s; echo "CHUNK FAILED rc=$s"; fi
done
echo "SUITE DONE rc=$rc"
exit $rc
