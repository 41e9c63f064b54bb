"""raytracingweekend_jl_tpu — a differentiable path-tracing framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
claforte/RayTracingWeekend.jl (the reference, surveyed in SURVEY.md): sphere
scenes with Lambertian/Metal/Dielectric materials, a thin-lens camera with
defocus blur, and a book-1 path integrator — rebuilt as a single differentiable
JAX program with SoA scenes, a wavefront integrator, counter-based RNG, Pallas
intersection kernels, and shard_map multi-chip/multi-host rendering.

Public surface mirrors the reference's exports (src/RayTracingWeekend.jl:10-31)
re-idiomized for arrays-first usage.
"""

from .scene import (Scene, make_scene, sphere, lambertian, metal, dielectric,
                    LAMBERTIAN, METAL, DIELECTRIC)
from .camera import (Camera, default_camera, get_rays,
                     t_default_cam, t_cam1, t_cam2, hollow_glass_cam)
from .render import render, render_radiance, image_height_for, pixel_coords
from .ops.integrator import (trace, trace_compacted, persistent_render_sum,
                             trace_occupancy, skycolor, DEFAULT_MAX_DEPTH)
from .ops.intersect import intersect_spheres, HitResult, DEFAULT_TMIN
from .ops.materials import scatter, ScatterResult
from .ops.vecmath import (dot, squared_length, near_zero, normalize, reflect,
                          refract, reflectance, gamma2_encode, color_vec3_in_rgb)
from .ops.sampling import unit_sphere_directions, unit_disk_points, uniform_between
from .models.scenes import (scene_2_spheres, scene_4_spheres, scene_diel_spheres,
                            scene_diel_spheres_hollow, scene_blue_red_spheres,
                            scene_random_spheres, scene_random_spheres_reference,
                            save_scene, load_scene, ALL_SCENES)
# Differentiable-rendering / training surface (no reference equivalent —
# SURVEY.md §2.9 north star).
from .grad import (render_loss, render_grads, sgd_inverse_render_step,
                   SceneGrads, resolve_grad_path)
from .optimize import fit_scene, fit_scene_scan, movable_mask, FitResult
from .ops.edge import render_radiance_edge, trace_edge

__version__ = "0.1.0"
