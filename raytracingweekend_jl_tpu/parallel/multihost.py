"""Multi-host rendering: jax.distributed init + host-local tile IO.

The reference never crosses a process boundary (SURVEY.md §2.4). The
multi-host design here: every host runs the same program; the global
``(tiles, samples)`` mesh spans all hosts with the ``tiles`` axis laid out so
contiguous tile blocks are host-local (tile assembly needs no cross-host
traffic — each host writes its own image strip; the only cross-host
collective is the ``samples`` psum and, for training, the gradient
all-reduce inserted by the shard_map transpose).

This module is exercised single-process via the driver's ``dryrun_multichip``
(virtual CPU mesh) and cross-process by tests/test_multiprocess.py (a REAL
2-process ``jax.distributed`` launch incl. strip IO); on a cluster call
:func:`initialize` first — with explicit coordinates, or with none under a
launcher (Slurm, Open MPI, or a ``JAX_COORDINATOR_ADDRESS`` spec) that JAX's
argless ``jax.distributed.initialize()`` can read.
"""

from __future__ import annotations

import os

import jax
import numpy as np

from jax.sharding import Mesh

from .mesh import TILES_AXIS, SAMPLES_AXIS

#: Environment markers that carry an explicit coordinator address: any of
#: these present => an argless ``jax.distributed.initialize()`` can resolve
#: the cluster.
_CLUSTER_ENV_MARKERS = (
    "COORDINATOR_ADDRESS",             # generic JAX cluster spec
    "JAX_COORDINATOR_ADDRESS",
)


def cluster_env_hint(environ=None) -> bool:
    """True when the environment indicates a multi-process cluster launch —
    the decision table for :func:`initialize`'s argless auto-init path.

    A coordinator address counts on its own; Slurm and Open MPI count only
    with a task count above 1, so a single-task shell stays a no-op.
    """
    env = os.environ if environ is None else environ
    if any(m in env for m in _CLUSTER_ENV_MARKERS):
        return True
    for count_var in ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            if int(env.get(count_var, "1")) > 1:
                return True
        except ValueError:
            pass
    return False


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """``jax.distributed.initialize`` wrapper. Returns True when the
    distributed runtime was initialized.

    Three modes (an explicit-args-only wrapper would silently no-op on a
    real cluster, leaving N disconnected processes):

    - explicit ``num_processes > 1``: initialize with the given coordinates
      (the form the 2-process test uses);
    - no arguments, cluster detected (:func:`cluster_env_hint`): pass through
      to the *argless* ``jax.distributed.initialize()``, which resolves
      coordinator/process-id from the launcher's environment;
    - otherwise: single-process no-op.
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        return True
    if num_processes is None and coordinator_address is None \
            and cluster_env_hint():
        jax.distributed.initialize()
        return True
    return False


def make_multihost_mesh(n_samples_axis: int = 1) -> Mesh:
    """Global mesh over all processes' devices in ``jax.devices()`` order:
    hosts stacked along ``tiles``, consecutive devices (the cards of one
    host) along ``samples``, so the radiance/grad psum stays inside a host
    whenever ``n_samples_axis`` divides the per-host device count."""
    devs = np.asarray(jax.devices())
    n = devs.size
    if n % n_samples_axis:
        raise ValueError(f"{n} devices not divisible by samples axis {n_samples_axis}")
    return Mesh(devs.reshape(n // n_samples_axis, n_samples_axis),
                (TILES_AXIS, SAMPLES_AXIS))


def host_local_rows(image_height: int, image_width: int,
                    tile_size: int) -> tuple[int, int]:
    """The [start, stop) pixel range whose tiles live on this process —
    for host-local image-strip IO (each host saves only its shard)."""
    n_pix = image_height * image_width
    tiles_total = -(-n_pix // tile_size)
    per_proc = -(-tiles_total // jax.process_count())
    start = min(n_pix, jax.process_index() * per_proc * tile_size)
    stop = min(n_pix, (jax.process_index() + 1) * per_proc * tile_size)
    return start, stop


def strip_path(directory: str, process_index: int | None = None) -> str:
    """Canonical per-process strip file name inside ``directory``."""
    idx = jax.process_index() if process_index is None else process_index
    return os.path.join(directory, f"strip_{idx:05d}.npz")


def local_strip(image, image_height: int, image_width: int,
                tile_size: int) -> tuple[int, int, np.ndarray]:
    """THIS host's pixel strip ``(start, stop, [stop-start, 3])`` of a
    (possibly globally-sharded) [H, W, 3] image.

    Only locally-addressable shard data is fetched (no collective, no
    cross-host gather). The strip range is whatever pixel rows this process
    actually holds — the compiler may re-balance the output sharding away
    from the tile layout (observed: a 5/4-tile split re-sharded to even
    rows), so the addressable shards, not ``host_local_rows``, are the
    ground truth. If the local data covers the whole image (replicated
    output / single process), the process takes its ``host_local_rows``
    share so strips still partition the image.
    """
    n_pix = image_height * image_width
    if isinstance(image, jax.Array) and not image.is_fully_addressable:
        flat = np.zeros((n_pix, 3), np.float32)
        mask = np.zeros((n_pix,), bool)
        for shard in image.addressable_shards:
            rs = shard.index[0]
            r0 = 0 if rs.start is None else rs.start
            if shard.data.shape[1] != image_width:
                raise ValueError("image is sharded along columns; strip IO "
                                 "expects full-row shards")
            data = np.asarray(shard.data, np.float32).reshape(-1, 3)
            p0 = r0 * image_width
            flat[p0:p0 + len(data)] = data
            mask[p0:p0 + len(data)] = True
        if mask.all():
            start, stop = host_local_rows(image_height, image_width, tile_size)
        else:
            covered = np.flatnonzero(mask)
            start, stop = int(covered[0]), int(covered[-1]) + 1
            if not mask[start:stop].all():
                raise ValueError("host-local shards are not a contiguous "
                                 "pixel range; cannot write a strip")
        return start, stop, flat[start:stop]
    start, stop = host_local_rows(image_height, image_width, tile_size)
    return start, stop, np.asarray(image, np.float32).reshape(
        n_pix, 3)[start:stop]


def write_host_strip(image, image_height: int, image_width: int,
                     tile_size: int, directory: str,
                     strip: tuple[int, int, np.ndarray] | None = None
                     ) -> tuple[int, int]:
    """Save THIS host's pixel strip of a (possibly globally-sharded) image
    (see :func:`local_strip`). ``strip`` short-circuits the extraction when
    the caller already holds ``(start, stop, data)`` — the checkpointed
    driver accumulates strips on the host across spp chunks. Returns the
    [start, stop) pixel range written."""
    start, stop, data = (local_strip(image, image_height, image_width,
                                     tile_size) if strip is None else strip)
    os.makedirs(directory, exist_ok=True)
    np.savez(strip_path(directory), start=start, stop=stop,
             strip=np.asarray(data, np.float32),
             image_height=image_height, image_width=image_width)
    return start, stop


def assemble_strips(directory: str) -> np.ndarray:
    """Reassemble a full [H, W, 3] image from per-process strip files.

    Raises if the strips do not tile the image exactly (a missing host's file
    surfaces as a coverage error, not a silently black band).
    """
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("strip_") and f.endswith(".npz"))
    if not files:
        raise FileNotFoundError(f"no strip files in {directory}")
    parts = [np.load(os.path.join(directory, f)) for f in files]
    H = int(parts[0]["image_height"])
    W = int(parts[0]["image_width"])
    out = np.zeros((H * W, 3), parts[0]["strip"].dtype)
    covered = 0
    for z in sorted(parts, key=lambda z: int(z["start"])):
        start, stop = int(z["start"]), int(z["stop"])
        if start != covered:
            raise ValueError(f"strip gap/overlap at pixel {covered} "
                             f"(next strip starts at {start})")
        out[start:stop] = z["strip"]
        covered = stop
    if covered != H * W:
        raise ValueError(f"strips cover {covered} of {H * W} pixels")
    return out.reshape(H, W, 3)
