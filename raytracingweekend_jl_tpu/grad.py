"""Differentiable rendering — gradients of image losses w.r.t. scene parameters.

The reference has no autodiff at all (SURVEY.md §2.9); this module supplies the
north-star capability: ``grad(loss(render))`` w.r.t. sphere centers, radii, and
albedos. Gradients flow through every continuous quantity (hit distance t, hit
point, normal, attenuation products, Schlick reflectance, sky lerp) while the
discrete events (closest-hit argmin, material code, reflect-vs-refract coin,
front-face flip) are treated as detached choices — the straight-through
estimator pattern of RayTracer.jl (PAPERS.md). Visibility/silhouette boundary
terms are not estimated (interior gradients only), which is exactly what
finite-difference tests validate away from silhouettes.

The default gradient integrator is the recorded path (ops/grad_trace.py): a
custom VJP that records each bounce's state in the forward and replays it
without a sphere sweep in the backward. ``recorded=False, remat=True`` selects
the checkpointed XLA transpose instead.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .camera import Camera
from .render import render_radiance
from .scene import Scene

#: Fields of :class:`Scene` that are differentiable parameters.
DIFF_FIELDS = ("center", "radius", "albedo", "fuzz", "ir")

#: Explicit device-memory budget (bytes) for the recorded path's per-bounce
#: records. ``None`` (the default) resolves from the device at first use
#: (:func:`record_hbm_budget`); RTW_RECORD_HBM_GB pins it, and tests
#: monkeypatch this attribute directly.
RECORD_HBM_BUDGET = (int(float(os.environ["RTW_RECORD_HBM_GB"]) * 2**30)
                     if "RTW_RECORD_HBM_GB" in os.environ else None)

#: Share of the device's allocator limit kept back from the records for
#: everything else that is live during a gradient step: wavefront state, the
#: reverse scan's cotangent buffers, XLA temporaries and allocator slack.
RESERVE_FRACTION = 0.25

#: Budget on the CPU backend, where records live in host memory and the
#: number only steers pixel chunking.
CPU_RECORD_BUDGET = 8 * 2**30

_RESOLVED_HBM_BUDGET: int | None = None


def budget_from_memory_stats(stats: dict | None) -> int:
    """Record budget for an accelerator whose allocator reports ``stats``
    (``Device.memory_stats()``): ``bytes_limit`` less
    :data:`RESERVE_FRACTION` of it. Raises when the device reports no limit
    — there is no table of devices to guess from."""
    limit = (stats or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            "the accelerator reports no memory_stats()['bytes_limit']; pin "
            "the record budget with RTW_RECORD_HBM_GB")
    return int(limit * (1.0 - RESERVE_FRACTION))


def record_hbm_budget() -> int:
    """Bytes of device memory the recorded gradient path may spend on path
    records. Explicit ``RECORD_HBM_BUDGET`` (env / monkeypatch) wins;
    otherwise the first local device decides (:func:`budget_from_memory_stats`
    on an accelerator, :data:`CPU_RECORD_BUDGET` on the CPU)."""
    if RECORD_HBM_BUDGET is not None:
        return RECORD_HBM_BUDGET
    global _RESOLVED_HBM_BUDGET
    if _RESOLVED_HBM_BUDGET is None:
        dev = jax.local_devices()[0]
        _RESOLVED_HBM_BUDGET = (CPU_RECORD_BUDGET if dev.platform == "cpu"
                                else budget_from_memory_stats(
                                    dev.memory_stats()))
    return _RESOLVED_HBM_BUDGET

#: Per-ray-per-bounce record cost: 12 floats (org, dir, thr, t) + index +
#: 2 bools, f32-dominated, doubled for the reverse scan's cotangent buffers.
_RECORD_BYTES_PER_RAY_BOUNCE = 12 * 4 * 2 + 8


def auto_pixel_chunk(n_pix: int, max_depth: int,
                     budget: int | None = None,
                     bytes_per_ray_bounce: int | None = None,
                     soft_cap: int = 1 << 20) -> int | None:
    """Pixel chunk that keeps the recorded-path residuals inside device
    memory.

    The recorded integrator (ops/grad_trace.py) stashes ~12 floats per ray per
    bounce; a flagship-resolution ``render_grads`` with default args must not
    OOM just because the caller didn't read a docstring. Returns ``None``
    when the whole image fits, else the largest 8192-aligned chunk within
    the budget. The floor is 8192 rays, so a pathologically small budget
    floors there rather than returning an unrunnable chunk (8192 rays of
    records is ~12 MB, negligible on any real device).
    """
    budget = record_hbm_budget() if budget is None else budget
    if bytes_per_ray_bounce is None:
        bytes_per_ray_bounce = _RECORD_BYTES_PER_RAY_BOUNCE
    r_max = budget // (bytes_per_ray_bounce * max(max_depth, 1))
    # Soft cap besides device memory: at most ``soft_cap`` rays of records
    # per chunk.
    r_max = min(r_max, soft_cap)
    # Floor BEFORE the ceil-divide: a budget below one ray-bounce of record
    # bytes would make r_max == 0 and the division below crash.
    r_max = max(r_max, 8192)
    if n_pix <= r_max:
        return None
    # BALANCE the chunks: every chunk is padded to the chunk size and pays
    # full cost, so ceil-dividing the image into the fewest equal chunks
    # beats a power-of-two chunk with a mostly-padding tail (1920x1080 with
    # a 1M chunk would make 3 chunks, the third 93% padding).
    n_chunks = -(-n_pix // r_max)
    chunk = -(-n_pix // n_chunks)
    return max(8192, -(-chunk // 8192) * 8192)


class SceneGrads(NamedTuple):
    """Gradient pytree matching the differentiable subset of :class:`Scene`."""

    center: jnp.ndarray
    radius: jnp.ndarray
    albedo: jnp.ndarray
    fuzz: jnp.ndarray
    ir: jnp.ndarray


def _with_params(scene: Scene, params: SceneGrads) -> Scene:
    return scene._replace(**params._asdict())


def _params_of(scene: Scene) -> SceneGrads:
    return SceneGrads(**{f: getattr(scene, f) for f in DIFF_FIELDS})


def resolve_grad_path(kwargs: dict) -> dict:
    """Resolve the gradient-integrator selection in place (and return it).

    The default is the XLA recorded path (ops/grad_trace.py). Explicit flags
    are respected: ``recorded=False, remat=True`` picks the checkpointed XLA
    transpose, ``remat=True`` alone implies it, ``recorded_stage`` pins the
    staged recorded variant. The forward-only ``persistent``/``compact``
    flags have no VJP and are refused.
    """
    for fwd_only in ("persistent", "compact"):
        if kwargs.get(fwd_only):
            raise ValueError(
                f"{fwd_only}=True is a forward-only rendering flag; the "
                "gradient integrators are selected via recorded / remat / "
                "recorded_stage (or left to the default)")
    kwargs.setdefault("recorded", not kwargs.get("remat", False))
    kwargs.setdefault("remat", not kwargs["recorded"])
    return kwargs


def plan_pass_memory(kwargs: dict, n_pix: int, n_samples: int) -> dict:
    """Decide whether the recorded pass loop fits device memory (in place;
    returns kwargs).

    Reverse-mode keeps every sample pass's path records alive; at high spp
    that is n_pass x whole-image records. When the total exceeds the budget,
    ``remat_passes=True`` checkpoints the pass loop: every pass's record
    forward is recomputed in the backward, for O(1) residual memory in spp.
    """
    if not kwargs.get("recorded") or "remat_passes" in kwargs \
            or n_samples <= 1:
        return kwargs
    total = n_pix * n_samples * _RECORD_BYTES_PER_RAY_BOUNCE \
        * kwargs.get("max_depth", 16)
    kwargs["remat_passes"] = total > record_hbm_budget()
    return kwargs


def render_loss(scene: Scene, cam: Camera, target: jnp.ndarray,
                image_width: int, n_samples: int,
                loss_fn: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] | None = None,
                **kwargs) -> jnp.ndarray:
    """Scalar image loss of a differentiable render against ``target`` [H,W,3]
    (linear radiance, not gamma-encoded — compare in linear space).

    With no path flags the integrator is the XLA recorded path
    (ops/grad_trace.py — primal bitwise-identical to the plain trace). Pass
    ``recorded=False, remat=True`` for the checkpointed XLA transpose, or
    ``recorded_stage`` to pin the staged variant (see scripts/grad_bench.py).
    ``pixel_chunk`` is auto-picked to keep path records inside device
    memory."""
    # The image height is defined by `target`; a caller-supplied duplicate
    # must agree (render_radiance would otherwise get two values).
    ih = kwargs.pop("image_height", None)
    if ih is not None and ih != target.shape[0]:
        raise ValueError(f"image_height={ih} conflicts with "
                         f"target height {target.shape[0]}")
    resolve_grad_path(kwargs)
    if kwargs["recorded"] and "pixel_chunk" not in kwargs:
        kwargs["pixel_chunk"] = auto_pixel_chunk(
            target.shape[0] * image_width, kwargs.get("max_depth", 16))
    plan_pass_memory(kwargs, target.shape[0] * image_width, n_samples)
    img = render_radiance(scene, cam, image_width, n_samples,
                          image_height=target.shape[0], **kwargs)
    if loss_fn is None:
        return jnp.mean((img - target) ** 2)
    return loss_fn(img, target)


def render_grads(scene: Scene, cam: Camera, target: jnp.ndarray,
                 image_width: int, n_samples: int, **kwargs
                 ) -> tuple[jnp.ndarray, SceneGrads]:
    """(loss, gradients w.r.t. every differentiable scene field)."""

    def f(params: SceneGrads):
        return render_loss(_with_params(scene, params), cam, target,
                           image_width, n_samples, **kwargs)

    loss, grads = jax.value_and_grad(f)(_params_of(scene))
    return loss, grads


class GradSanityError(RuntimeError):
    """A gradient failed the built-in sanity tripwire (non-finite values or
    an absurd magnitude). Raised so corrupted measurements FAIL the run
    instead of landing in a benchmark record."""


def check_grads_sane(grads, loss=None, max_abs: float = 1e3) -> None:
    """Host-side tripwire for gradient records: every leaf must be finite and
    its |sum| and max-|elem| below ``max_abs`` (the book scenes' true
    gradient sums are O(0.05); 1e3 is ~4 orders of margin while catching
    blown values instantly). Call it from benchmark/session drivers after
    fetching gradients — it is NOT jittable (it inspects concrete values).
    Raises :class:`GradSanityError` with the offending field."""
    import numpy as np
    if loss is not None:
        lv = float(np.asarray(loss))
        if not np.isfinite(lv):
            raise GradSanityError(f"loss is not finite: {lv}")
    # Derive leaf names from the tree paths (not grads._fields): a field
    # that is itself a multi-leaf pytree would otherwise mislabel or
    # silently truncate the zip.
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, leaf in flat:
        name = jax.tree_util.keystr(path).lstrip(".") or "<root>"
        a = np.asarray(leaf)
        if not np.isfinite(a).all():
            raise GradSanityError(f"grad[{name}] contains non-finite values "
                                  f"({np.count_nonzero(~np.isfinite(a))} of "
                                  f"{a.size})")
        s, m = abs(float(a.sum())), float(np.abs(a).max())
        if s > max_abs or m > max_abs:
            raise GradSanityError(
                f"grad[{name}] magnitude implausible: |sum|={s:.4g}, "
                f"max|elem|={m:.4g} (bound {max_abs:g}) — likely kernel "
                "corruption; re-run and audit before recording")


def twin_ad_canary(scene: Scene, cam: Camera, width: int = 256,
                   n_samples: int = 8, **kwargs) -> None:
    """Cheap once-per-session corruption cross-check: gradients from the
    recorded integrator and the remat (pure-XLA transpose) integrator on a
    small config. The two paths share no replay code but estimate the same
    gradient, so the check is NOISE-ROBUST — per-field L2 norms within 4x
    and cosine similarity > 0.5 — which still catches a corrupted replay
    instantly (such corruption blows the norm up by orders of magnitude).
    Raises :class:`GradSanityError` on disagreement."""
    import numpy as np
    target = render_radiance(scene, cam, width, 1, seed=123)
    bad = scene._replace(albedo=jnp.clip(scene.albedo * 0.8, 0, 1))
    # Shared render config (depth, tmin, chunking, ...) must apply to BOTH
    # twins — the whole point is two estimators of the SAME gradient.
    # Path-selection keys and the fixed seed stay pinned per twin.
    shared = {k: v for k, v in kwargs.items()
              if k not in ("recorded", "remat", "recorded_stage", "seed")}
    rec_kw = {k: v for k, v in kwargs.items() if k != "seed"}
    _, g_rec = render_grads(bad, cam, target, width, n_samples, seed=5,
                            **rec_kw)
    _, g_ref = render_grads(bad, cam, target, width, n_samples, seed=5,
                            recorded=False, remat=True, **shared)
    check_grads_sane(g_rec)
    check_grads_sane(g_ref)
    for name in SceneGrads._fields:
        a = np.asarray(getattr(g_rec, name), np.float64).ravel()
        b = np.asarray(getattr(g_ref, name), np.float64).ravel()
        na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
        if nb < 1e-9 and na < 1e-9:
            continue
        ratio = na / max(nb, 1e-12)
        if not (0.25 < ratio < 4.0):
            raise GradSanityError(
                f"twin-AD canary: grad[{name}] recorded-vs-remat norm ratio "
                f"{ratio:.3g} (want 0.25-4) — recorded gradients look "
                "corrupted")
        if name == "albedo":
            # Direction check only where the loss has real signal (the
            # canary perturbs albedo): incidental fields (center/fuzz/ir)
            # are MC-noise-dominated at canary spp, so two independent
            # unbiased estimates of them are legitimately near-orthogonal.
            cos = float(a @ b) / max(na * nb, 1e-24)
            if cos < 0.5:
                raise GradSanityError(
                    f"twin-AD canary: grad[albedo] recorded-vs-remat cosine "
                    f"{cos:.3f} (want >0.5) — recorded gradients look "
                    "corrupted")


def sgd_inverse_render_step(scene: Scene, cam: Camera, target: jnp.ndarray,
                            image_width: int, n_samples: int, lr: float = 0.01,
                            **kwargs) -> tuple[jnp.ndarray, Scene]:
    """One gradient-descent step fitting scene parameters to a target image —
    the single-chip version of the "training step" (see parallel/shard.py for
    the sharded one)."""
    loss, grads = render_grads(scene, cam, target, image_width, n_samples, **kwargs)
    new_params = jax.tree.map(lambda p, g: p - lr * g, _params_of(scene),
                              grads)
    return loss, _with_params(scene, new_params)
