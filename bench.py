"""Flagship-scene path throughput on the accelerator.

Prints ONE final JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline (BASELINE.md): the reference renders random_spheres 1920x1080x1000spp
in 1282.4 s on a 16-thread Ryzen 3700 = 1.617 Mpaths/s. ``vs_baseline`` is our
steady-state Mpaths/s divided by that (higher is better). The flagship
wall-clock estimate for the full 1000 spp render is included as an extra field.

Budget design (a benchmark must print its line even when compilation or
the device stalls):

* one overall deadline (``RTW_BENCH_DEADLINE_S``, default 520 s) governs
  everything; no per-attempt budget can exceed what remains of it;
* the child STREAMS one JSON event line per measured chunk, so a partial run
  still yields a real number — the parent computes the result from whatever
  chunks arrived before the deadline;
* the parent emits the final JSON line from a SIGALRM watchdog armed ahead
  of the deadline (and on SIGTERM/SIGINT), so an external ``timeout`` kill
  cannot silence it; if nothing was measured the line carries value 0 and
  the error, with rc 0.

The parent never imports JAX, so the child is the only process on the
device.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

# Reference flagship: 1920*1080*1000 paths / 1282.4 s (BASELINE.md).
BASELINE_MPATHS_PER_S = 1920 * 1080 * 1000 / 1282.4 / 1e6  # ~1.617
FLAGSHIP_PATHS = 1920 * 1080 * 1000
W, H = 1920, 1080

DEADLINE_S = float(os.environ.get("RTW_BENCH_DEADLINE_S", "520"))
#: seconds reserved before the deadline for the parent to kill the child and
#: print the final line.
MARGIN_S = 12.0
SPP_CHUNK = 25
N_CHUNKS = 3


def child(spp_chunk: int, n_chunks: int) -> None:
    """Measure n_chunks flagship chunks, streaming one JSON line per event."""
    import numpy as np
    import jax
    from raytracingweekend_jl_tpu.utils.cache import enable_compilation_cache
    enable_compilation_cache()  # second run warms in seconds, not minutes
    import raytracingweekend_jl_tpu as rtw
    from raytracingweekend_jl_tpu.render import render_tile_sum, pixel_coords

    scene = rtw.scene_random_spheres(seed=1)
    cam = rtw.t_cam1()
    u, v = pixel_coords(W, H)
    key = jax.random.PRNGKey(0)
    f32_w, f32_h = float(np.float32(W)), float(np.float32(H))

    tile_sum = jax.jit(render_tile_sum,
                       static_argnames=("n_samples", "max_depth", "tmin",
                                        "remat", "f32_w", "f32_h", "compact",
                                        "samples_per_pass", "persistent"))

    def run_chunk(offset):
        # Persistent wavefront (lanes pinned to pixels, in-place sample
        # regeneration) + the sweep kernel — the production forward path.
        acc = tile_sum(scene, cam, u, v, key, n_samples=spp_chunk,
                       sample_offset=offset, max_depth=16, tmin=1e-4,
                       remat=False, f32_w=f32_w, f32_h=f32_h,
                       compact=False, samples_per_pass=1, persistent=True)
        return jax.block_until_ready(acc)

    t0 = time.perf_counter()
    run_chunk(0)  # compile + warm
    dev = jax.devices()[0]
    print(json.dumps({"event": "warm", "warm_s": time.perf_counter() - t0,
                      "device": f"{dev.platform}:{dev.device_kind}"}),
          flush=True)

    for c in range(1, n_chunks + 1):
        t0 = time.perf_counter()
        run_chunk(c * spp_chunk)
        print(json.dumps({"event": "chunk",
                          "steady_s": time.perf_counter() - t0}), flush=True)


class _Collector:
    """Best-so-far result assembled from streamed child events; can always
    render a final JSON line, exactly once."""

    def __init__(self):
        self.warm_s = None
        self.device = "unknown"
        self.chunk_times = []
        self.error = None
        self._emitted = False
        self._lock = threading.Lock()

    def feed(self, line: str) -> None:
        try:
            ev = json.loads(line)
        except json.JSONDecodeError:
            return
        if ev.get("event") == "warm":
            self.warm_s = ev.get("warm_s")
            self.device = ev.get("device", "unknown")
        elif ev.get("event") == "chunk":
            self.chunk_times.append(float(ev["steady_s"]))

    def emit(self) -> None:
        with self._lock:
            if self._emitted:
                return
            self._emitted = True
        if not self.chunk_times:
            rec = {
                "metric": "flagship_throughput_random_spheres_1920x1080",
                "value": 0.0, "unit": "Mpaths/s", "vs_baseline": 0.0,
                "error": self.error or "no chunk measured before deadline",
            }
            if self.warm_s is not None:
                rec["warm_s"] = round(self.warm_s, 1)
            print(json.dumps(rec), flush=True)
            return
        # Reference methodology is @benchmark MINIMA
        # (src/proto/proto.jl:197-200); min = steady state.
        steady_s = min(self.chunk_times)
        mpaths = W * H * SPP_CHUNK / steady_s / 1e6
        rec = {
            "metric": "flagship_throughput_random_spheres_1920x1080",
            "value": round(mpaths, 3),
            "unit": "Mpaths/s",
            "vs_baseline": round(mpaths / BASELINE_MPATHS_PER_S, 3),
            "baseline_mpaths_per_s": round(BASELINE_MPATHS_PER_S, 3),
            "flagship_wallclock_est_s": round(FLAGSHIP_PATHS / (mpaths * 1e6), 1),
            "baseline_flagship_wallclock_s": 1282.4,
            "spp_chunk": SPP_CHUNK,
            "n_chunks_measured": len(self.chunk_times),
            "warm_s": round(self.warm_s, 1) if self.warm_s is not None else None,
            "steady_mean_s": round(sum(self.chunk_times)
                                   / len(self.chunk_times), 3),
            "steady_max_s": round(max(self.chunk_times), 3),
            "device": self.device,
        }
        print(json.dumps(rec), flush=True)


def main() -> None:
    if os.environ.get("RTW_BENCH_CHILD"):
        child(int(sys.argv[1]), int(sys.argv[2]))
        return

    start = time.time()
    deadline = start + DEADLINE_S
    col = _Collector()
    procs = []

    def finish(*_args):
        col.emit()
        for p in procs:
            if p.poll() is None:
                p.kill()
        # Exit without waiting on the (possibly wedged) child.
        os._exit(0)

    signal.signal(signal.SIGTERM, finish)
    signal.signal(signal.SIGINT, finish)
    signal.signal(signal.SIGALRM, finish)
    signal.alarm(max(int(deadline - time.time() - MARGIN_S / 2), 1))

    env = dict(os.environ, RTW_BENCH_CHILD="1")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         str(SPP_CHUNK), str(N_CHUNKS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    procs.append(proc)

    stderr_tail = []

    def read_stderr():
        for line in proc.stderr:
            stderr_tail.append(line)
            del stderr_tail[:-20]

    threading.Thread(target=read_stderr, daemon=True).start()

    def read_stdout():
        for line in proc.stdout:
            col.feed(line)

    t = threading.Thread(target=read_stdout, daemon=True)
    t.start()
    while proc.poll() is None and time.time() < deadline - MARGIN_S:
        time.sleep(0.5)
    if proc.poll() is None:
        proc.kill()
        # Drain events the child wrote before the kill (a chunk line may
        # still sit in the pipe buffer — losing it would report value 0
        # despite a real measurement).
        t.join(timeout=1)
    else:
        t.join(timeout=5)
        if proc.returncode != 0 and not col.chunk_times:
            col.error = ("bench child exited rc=%d: %s"
                         % (proc.returncode, "".join(stderr_tail)[-400:]))
    finish()


if __name__ == "__main__":
    main()
