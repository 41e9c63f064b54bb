"""Thin-lens camera with defocus blur — batched ray generation.

Semantics match the reference camera exactly (reference: src/camera.jl:1-48):
precomputed frame (origin, lower-left corner, horizontal/vertical spans, u/v/w
basis, lens radius), ``default_camera`` built from
lookfrom/lookat/vup/vfov/aspect/aperture/focus_dist, and ray directions
normalised at creation so the intersection sweep can exploit ``a == 1``
(reference: src/hit.jl:14-15).

The array difference: ``get_rays`` is *batched* — it maps whole ``[R]`` arrays of
film coordinates plus an ``[R,2]`` lens sample to ``[R,3]`` origin/direction
planes in one fused XLA computation, instead of one ray at a time.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ops.vecmath import normalize
from .ops.sampling import unit_disk_points


class Camera(NamedTuple):
    """Precomputed camera frame (reference: struct Camera, src/camera.jl:1-10)."""

    origin: jnp.ndarray            # [3]
    lower_left_corner: jnp.ndarray # [3]
    horizontal: jnp.ndarray        # [3]
    vertical: jnp.ndarray          # [3]
    u: jnp.ndarray                 # [3]
    v: jnp.ndarray                 # [3]
    w: jnp.ndarray                 # [3]
    lens_radius: jnp.ndarray       # [] scalar


def default_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                   vup=(0.0, 1.0, 0.0), vfov=90.0, aspect_ratio=16.0 / 9.0,
                   aperture=0.0, focus_dist=1.0, dtype=jnp.float32) -> Camera:
    """Build a camera (reference: default_camera, src/camera.jl:18-36).

    Defaults replicate the reference's: vfov 90°, aspect 16/9, aperture 0,
    focus 1. ``dtype`` plays the role of the reference's ``elem_type`` kwarg
    (src/camera.jl:38-41).
    """
    # Frame construction in float64 on host for precision, cast once at the end.
    import numpy as np

    lookfrom = np.asarray(lookfrom, dtype=np.float64)
    lookat = np.asarray(lookat, dtype=np.float64)
    vup = np.asarray(vup, dtype=np.float64)

    viewport_height = 2.0 * math.tan(math.radians(vfov) / 2.0)
    viewport_width = aspect_ratio * viewport_height

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = lookfrom
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left_corner = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
    lens_radius = aperture / 2.0

    as_j = lambda x: jnp.asarray(x, dtype=dtype)
    return Camera(as_j(origin), as_j(lower_left_corner), as_j(horizontal),
                  as_j(vertical), as_j(u), as_j(v), as_j(w), as_j(lens_radius))


def make_rays(cam: Camera, s: jnp.ndarray, t: jnp.ndarray,
              disk_pts: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Deterministic core of ray generation: film coords + an explicit
    ``[R,2]`` unit-disk lens sample -> (origins, unit directions)
    (reference geometry: src/camera.jl:43-48). Callers supply the disk sample
    so RNG keying strategies (positional, slot-keyed, persistent) compose."""
    rd = cam.lens_radius * disk_pts
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    origin = cam.origin + offset
    direction = (cam.lower_left_corner
                 + s[..., None] * cam.horizontal
                 + t[..., None] * cam.vertical
                 - cam.origin - offset)
    return origin, normalize(direction)


def get_rays(cam: Camera, s: jnp.ndarray, t: jnp.ndarray,
             key: jax.Array) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched ``get_ray`` (reference: src/camera.jl:43-48).

    ``s``/``t`` are ``[R]`` film coordinates in [0,1]; returns ``([R,3] origins,
    [R,3] unit directions)``. The lens-disk sample uses the closed-form
    concentric map (same distribution as the reference's rejection loop,
    src/rand.jl:31-38) scaled by ``lens_radius``; for aperture-0 cameras the
    offset is exactly zero, matching the reference's behavior where the drawn
    disk sample is annihilated by ``lens_radius = 0`` (src/camera.jl:44).
    """
    dtype = cam.origin.dtype
    return make_rays(cam, s, t, unit_disk_points(key, s.shape, dtype=dtype))


# ---------------------------------------------------------------------------
# Canonical camera fixtures (SURVEY.md §2.8; reference: src/proto/proto.jl:17-22)
# ---------------------------------------------------------------------------

def t_default_cam(dtype=jnp.float32) -> Camera:
    """vfov 90, aspect 16/9, aperture 0 (reference: src/proto/proto.jl:17)."""
    return default_camera(dtype=dtype)


def t_cam1(dtype=jnp.float32) -> Camera:
    """Book-1 final camera (reference: src/proto/proto.jl:19)."""
    return default_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, 16.0 / 9.0,
                          0.1, 10.0, dtype=dtype)


def t_cam2(dtype=jnp.float32) -> Camera:
    """Big-aperture defocus demo camera (reference: src/proto/proto.jl:21-22)."""
    import numpy as np
    focus = float(np.linalg.norm(np.array([3.0, 3.0, 2.0]) - np.array([0.0, 0.0, -1.0])))
    return default_camera((3, 3, 2), (0, 0, -1), (0, 1, 0), 20.0, 16.0 / 9.0,
                          2.0, focus, dtype=dtype)


def hollow_glass_cam(dtype=jnp.float32) -> Camera:
    """Hollow-glass viewpoint (reference: src/pluto_RayTracingWeekend.jl:748-750)."""
    return default_camera((-2, 2, 1), (0, 0, -1), (0, 1, 0), 20.0, dtype=dtype)
