#!/bin/bash
# Snapshot gate: a commit must pass
#   1. the FULL test profile (slow + fast) on the 8-device CPU mesh,
#   2. the driver entry compile-check + multichip dryrun,
#   3. a CLI smoke render,
# and, with RTW_GATE_DEVICE=1 (on a machine with an NVIDIA GPU), the card
# smoke test and the bench headline. Run from anywhere; exits nonzero on any
# failure.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== gate: full test profile =="
python -m pytest tests/ -q -m "slow or not slow"

echo "== gate: entry + dryrun_multichip (8 virtual devices) =="
XLA_FLAGS="--xla_force_host_platform_device_count=8" JAX_PLATFORMS=cpu \
python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as g
fn, args = g.entry()
out = jax.jit(fn)(*args)
assert out.shape[-1] == 3
g.dryrun_multichip(8)
print("entry + dryrun ok")
EOF

echo "== gate: CLI smoke =="
tmp=$(mktemp -d)
python - <<EOF
import jax
jax.config.update("jax_platforms", "cpu")
import runpy, sys
sys.argv = ["cli", "--scene", "2_spheres", "--width", "96", "--spp", "4",
            "-o", "$tmp/out.png"]
runpy.run_module("raytracingweekend_jl_tpu.cli", run_name="__main__")
EOF
test -s "$tmp/out.png"
rm -rf "$tmp"

if [ "${RTW_GATE_DEVICE:-0}" = "1" ]; then
  echo "== gate: card smoke test =="
  python chip_smoke.py
  echo "== gate: bench headline =="
  python bench.py
fi

echo "GATE PASS"
