"""Device-mesh construction for sharded rendering.

The reference's only parallelism is ``Threads.@threads`` over image rows on one
host (reference: src/render.jl:23). The replacement here is a named 2-D mesh
``('tiles', 'samples')``:

- ``tiles``: pixel-tile data parallelism (the primary axis — the analog of the
  reference's row loop);
- ``samples``: samples-per-pixel parallelism, reduced with ``psum`` (the axis
  the reference only has as a sequential per-pixel loop, src/render.jl:29-39).

The mesh follows the algorithm alone: devices are taken in ``jax.devices()``
order, because the cards of a host are joined all to all (NVLink) and no
device placement is cheaper than another for the ``samples`` psum.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TILES_AXIS = "tiles"
SAMPLES_AXIS = "samples"


def make_render_mesh(n_tiles: int | None = None, n_samples: int = 1,
                     devices=None) -> Mesh:
    """Build a ``(tiles, samples)`` mesh.

    Defaults to all visible devices on the ``tiles`` axis. ``n_tiles *
    n_samples`` must equal the device count used.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_tiles is None:
        n_tiles = n_dev // n_samples
    if n_tiles * n_samples != n_dev:
        raise ValueError(
            f"mesh {n_tiles}x{n_samples} != {n_dev} devices")
    dev_array = np.asarray(devices).reshape(n_tiles, n_samples)
    return Mesh(dev_array, (TILES_AXIS, SAMPLES_AXIS))
