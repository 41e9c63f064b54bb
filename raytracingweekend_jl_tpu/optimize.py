"""Inverse-rendering optimization — the framework's training surface.

The reference renderer has no autodiff at all (SURVEY.md §2.9 north star);
this module turns the differentiable renderer into a working scene-fitting
loop. The estimator is a measured HYBRID (bench_history inverse_* rows):

- **appearance parameters** (albedo; extendable to fuzz/ir): exact interior
  autodiff via ``value_and_grad`` of the recorded integrator. Appearance
  never moves silhouettes, so the reparameterized path derivative is the
  whole gradient and Adam converges cleanly.
- **geometry parameters** (centers): **SPSA** — simultaneous-perturbation
  stochastic approximation: probe pairs ``loss(c ± eps*delta)`` with a
  shared Rademacher direction ``delta``, gradient estimate
  ``(L+ - L-)/(2 eps) * delta``. Interior-only autodiff is actively WRONG
  for geometry on this loss: the MSE is dominated by silhouette/visibility
  terms that the path derivative cannot see (measured: FD ~200x larger and
  differently signed than AD at eps=1e-3 — grad.py's documented
  no-boundary-term limitation), so AD-Adam walks centers uphill. SPSA's
  finite probes DO see silhouettes, at two cheap non-differentiable
  production-forward renders per pair.

The RNG seed is FIXED across steps and shared by both probes of every SPSA
pair: the loss surface is deterministic, so differences isolate the
parameter effect. (Per-step reseeding was measured to inject a
variance-gradient bias — darkening reduces estimator variance, the classic
MSE inverse-rendering pathology.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .camera import Camera
from .grad import render_loss
from .render import render_radiance
from .scene import Scene


@dataclass
class FitResult:
    scene: Scene                      #: fitted scene
    losses: list = field(default_factory=list)   #: per-step loss values
    step_seconds: list = field(default_factory=list)  #: per-step wall time


def movable_mask(scene: Scene, radius_cap: float = 10.0) -> np.ndarray:
    """Spheres the fit may move: real (non-padding) and not the ground
    sphere (reference scenes model the ground as a huge sphere,
    src/scenes.jl:9-14 — moving it underfoot is never the task)."""
    r = np.asarray(scene.radius)
    return (r != 0) & (np.abs(r) < radius_cap)


def fit_scene(scene0: Scene, cam: Camera, target: jnp.ndarray,
              image_width: int, n_samples: int, *,
              steps: int = 100, seed: int = 0,
              lr_albedo: float = 2e-2, lr_center: float = 8e-3,
              lr_fuzz: float = 0.0,
              spsa_c: float = 2e-2, spsa_pairs: int = 2,
              movable: np.ndarray | None = None,
              render_kwargs: dict | None = None,
              geom: str = "spsa", edge_kwargs: dict | None = None,
              cosine_decay: bool = False,
              on_step=None) -> FitResult:
    """Recover sphere centers + albedos of ``scene0`` so its render matches
    ``target`` ([H,W,3] linear radiance). Returns the fitted scene and the
    loss trajectory. ``on_step(i, loss, params)`` is an optional callback.

    ``render_kwargs`` configures the DIFFERENTIABLE render used for the loss
    and albedo gradient (e.g. ``dict(pixel_chunk=1 << 18)``); SPSA probes
    always use the production forward (the persistent integrator).

    ``geom`` selects the GEOMETRY (center) gradient estimator:
      - ``"spsa"`` (default): the measured hybrid above — exact AD for
        albedo, SPSA probe pairs for centers.
      - ``"edge"``: pure autodiff via the boundary-aware edge renderer
        (ops/edge.py) — ONE value_and_grad supplies both albedo (interior)
        and center (interior + silhouette boundary) gradients; no probes.
        ``edge_kwargs`` forwards ``sigma`` / ``sigma_px`` / ``edge_bounces``.

    ``lr_fuzz > 0`` additionally fits metal fuzz (masked to movable METAL
    spheres, clipped to the reference's unclamped-but-nonnegative domain
    src/scenes.jl:70; route through geom="edge" with edge_bounces>=2 —
    fuzz's gradient lives in reflected-silhouette visibility, docs/EDGE.md).

    ``cosine_decay`` anneals every lr to 0 over ``steps``. Adam gives
    noise-dominated coordinates (tiny/occluded spheres) lr-sized steps
    regardless of gradient magnitude, so they random-walk ~lr*steps while
    constrained coordinates converge (measured on the 485-sphere flagship
    fit: max center error grew to ~lr*steps with constant lr); the decay
    freezes the walk as the fit converges.
    """
    import optax

    if geom not in ("spsa", "edge"):
        raise ValueError(f"geom must be 'spsa' or 'edge', got {geom!r}")
    H = target.shape[0]
    # Empty/None render_kwargs defer to grad.resolve_grad_path's default.
    tkw = dict(render_kwargs) if render_kwargs else {}
    seed = tkw.pop("seed", seed)
    if movable is None:
        movable = movable_mask(scene0)
    mov = jnp.asarray(movable)[:, None]
    mov_np = np.asarray(movable)[:, None]

    from .scene import METAL
    fit_fuzz = lr_fuzz > 0
    fuzz_mask = jnp.asarray(movable
                            & (np.asarray(scene0.mat) == METAL), jnp.float32)
    params = {"center": scene0.center, "albedo": scene0.albedo}
    def _lr(v):
        return (optax.cosine_decay_schedule(v, max(steps, 1))
                if cosine_decay else v)
    lrs = {"center": optax.adam(_lr(lr_center)),
           "albedo": optax.adam(_lr(lr_albedo))}
    if fit_fuzz:
        params["fuzz"] = scene0.fuzz
        lrs["fuzz"] = optax.adam(_lr(lr_fuzz))
    opt = optax.multi_transform(lrs, {k: k for k in lrs})
    opt_state = opt.init(params)

    def _scene_of(p, center):
        s = scene0._replace(center=center,
                            albedo=jnp.clip(p["albedo"], 0.0, 1.0))
        if fit_fuzz:
            s = s._replace(fuzz=jnp.maximum(p["fuzz"], 0.0))
        return s

    if geom == "edge":
        from .ops.edge import render_radiance_edge
        ekw = dict(edge_kwargs or {})
        if tkw:
            # The edge branch reads edge_kwargs only; silently dropping a
            # caller's render_kwargs (e.g. memory-bounding pixel_chunk
            # they relied on) would be a silent failure.
            raise ValueError(
                f"render_kwargs {sorted(tkw)} have no effect with "
                "geom='edge' — configure the edge loss via edge_kwargs "
                "(sigma/sigma_px/edge_bounces/pixel_chunk/remat_chunks)")

        def step_loss(p):
            # Boundary-aware AD: centers keep their cotangent chain — the
            # edge renderer's straight-through silhouette terms make it
            # descend where interior-only AD walks uphill (ops/edge.py).
            img = render_radiance_edge(_scene_of(p, p["center"]), cam,
                                       image_width, n_samples,
                                       image_height=H, seed=seed, **ekw)
            return jnp.mean((img - target) ** 2)
    else:
        def step_loss(p):
            # Centers are fit by SPSA (their AD gradient is discarded), so
            # the backward pass need not build their cotangent chain at all.
            s = _scene_of(p, jax.lax.stop_gradient(p["center"]))
            return render_loss(s, cam, target, image_width, n_samples,
                               seed=seed, **tkw)

    # ONE program per step: the whole value_and_grad (all chunks + loss
    # glue) is jitted as a unit and reused across the loop.
    vg = jax.jit(jax.value_and_grad(step_loss))

    @jax.jit
    def fwd_loss(center, albedo, fuzz):
        s = scene0._replace(center=center, albedo=jnp.clip(albedo, 0, 1),
                            fuzz=jnp.maximum(fuzz, 0.0))
        img = render_radiance(s, cam, image_width, n_samples,
                              image_height=H, seed=seed, persistent=True)
        return jnp.mean((img - target) ** 2)

    spsa_rng = np.random.default_rng(31 + seed)

    def spsa_center_grad(p):
        # Plain-Python probe loop over ONE jitted forward (the few extra
        # dispatches per step are small next to the renders).
        # spsa_pairs=0 disables center probing entirely (albedo-only fits:
        # exact AD, no SPSA noise, centers frozen under zero gradient).
        if spsa_pairs == 0:
            return jnp.zeros_like(p["center"])
        g = 0.0
        for _ in range(spsa_pairs):
            delta = jnp.asarray(
                (spsa_rng.integers(0, 2, scene0.center.shape) * 2 - 1)
                * mov_np, jnp.float32)
            fz = p.get("fuzz", scene0.fuzz)
            lp = fwd_loss(p["center"] + spsa_c * delta, p["albedo"], fz)
            lm = fwd_loss(p["center"] - spsa_c * delta, p["albedo"], fz)
            g = g + (lp - lm) / (2.0 * spsa_c) * delta
        return g / spsa_pairs

    result = FitResult(scene=scene0)
    for i in range(steps):
        t0 = time.time()
        loss, g_ad = vg(params)
        g_center = (g_ad["center"] * mov if geom == "edge"
                    else spsa_center_grad(params))
        g = {"center": g_center, "albedo": g_ad["albedo"] * mov}
        if fit_fuzz:
            g["fuzz"] = g_ad["fuzz"] * fuzz_mask
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        loss = float(loss)  # host fetch = sync
        result.losses.append(loss)
        result.step_seconds.append(time.time() - t0)
        if on_step is not None:
            on_step(i, loss, params)

    result.scene = _scene_of(params, params["center"])
    return result


def fit_scene_scan(scene0: Scene, cam: Camera, target: jnp.ndarray,
                   image_width: int, n_samples: int, *,
                   steps: int = 100, seed: int = 0,
                   lr_albedo: float = 2e-2, lr_center: float = 8e-3,
                   lr_fuzz: float = 0.0,
                   spsa_c: float = 2e-2, spsa_pairs: int = 2,
                   movable: np.ndarray | None = None,
                   render_kwargs: dict | None = None,
                   geom: str = "spsa",
                   edge_kwargs: dict | None = None,
                   cosine_decay: bool = False) -> FitResult:
    """:func:`fit_scene` as ONE jitted ``lax.scan`` — the whole optimization
    (value_and_grad + SPSA probes + Adam) runs on device in a single
    dispatch, so the per-step host round-trips (~5 dispatches per step in
    the loop variant) are paid once. Differences from :func:`fit_scene`:
    SPSA Rademacher draws come
    from a jax.random stream (statistically identical), and there is no
    per-step host callback — split into several scans to checkpoint
    mid-run. Returns the fitted scene and the full loss trajectory.
    ``geom``/``edge_kwargs`` as in :func:`fit_scene` (``"edge"`` = pure-AD
    boundary-aware gradients, no SPSA probes)."""
    import optax

    if geom not in ("spsa", "edge"):
        raise ValueError(f"geom must be 'spsa' or 'edge', got {geom!r}")
    H = target.shape[0]
    tkw = dict(render_kwargs) if render_kwargs else {}
    seed = tkw.pop("seed", seed)
    if movable is None:
        movable = movable_mask(scene0)
    mov = jnp.asarray(movable)[:, None]

    from .scene import METAL
    fit_fuzz = lr_fuzz > 0
    fuzz_mask = jnp.asarray(movable
                            & (np.asarray(scene0.mat) == METAL), jnp.float32)
    params0 = {"center": scene0.center, "albedo": scene0.albedo}
    def _lr(v):
        return (optax.cosine_decay_schedule(v, max(steps, 1))
                if cosine_decay else v)
    lrs = {"center": optax.adam(_lr(lr_center)),
           "albedo": optax.adam(_lr(lr_albedo))}
    if fit_fuzz:
        params0["fuzz"] = scene0.fuzz
        lrs["fuzz"] = optax.adam(_lr(lr_fuzz))
    opt = optax.multi_transform(lrs, {k: k for k in lrs})

    def _scene_of(p, center):
        s = scene0._replace(center=center,
                            albedo=jnp.clip(p["albedo"], 0.0, 1.0))
        if fit_fuzz:
            s = s._replace(fuzz=jnp.maximum(p["fuzz"], 0.0))
        return s

    if geom == "edge":
        from .ops.edge import render_radiance_edge
        ekw = dict(edge_kwargs or {})
        if tkw:
            raise ValueError(
                f"render_kwargs {sorted(tkw)} have no effect with "
                "geom='edge' — configure the edge loss via edge_kwargs "
                "(sigma/sigma_px/edge_bounces/pixel_chunk/remat_chunks)")

        def step_loss(p):
            img = render_radiance_edge(_scene_of(p, p["center"]), cam,
                                       image_width, n_samples,
                                       image_height=H, seed=seed, **ekw)
            return jnp.mean((img - target) ** 2)
    else:
        def step_loss(p):
            # Centers come from SPSA; skip their AD cotangent chain.
            s = _scene_of(p, jax.lax.stop_gradient(p["center"]))
            return render_loss(s, cam, target, image_width, n_samples,
                               seed=seed, **tkw)

    def fwd_loss(center, albedo, fuzz):
        s = scene0._replace(center=center, albedo=jnp.clip(albedo, 0, 1),
                            fuzz=jnp.maximum(fuzz, 0.0))
        img = render_radiance(s, cam, image_width, n_samples,
                              image_height=H, seed=seed, persistent=True)
        return jnp.mean((img - target) ** 2)

    def one_step(carry, _):
        params, opt_state, key = carry
        loss, g_ad = jax.value_and_grad(step_loss)(params)
        if geom == "edge":
            g_center = g_ad["center"] * mov
        else:
            g_center = jnp.zeros_like(params["center"])
            fz = params.get("fuzz", scene0.fuzz)
            for j in range(spsa_pairs):
                key, sub = jax.random.split(key)
                delta = (jax.random.bernoulli(
                    sub, 0.5, params["center"].shape).astype(jnp.float32)
                    * 2.0 - 1.0) * mov
                lp = fwd_loss(params["center"] + spsa_c * delta,
                              params["albedo"], fz)
                lm = fwd_loss(params["center"] - spsa_c * delta,
                              params["albedo"], fz)
                g_center = g_center + (lp - lm) / (2.0 * spsa_c) * delta
            # max(, 1): spsa_pairs=0 (albedo-only fit) leaves it zero.
            g_center = g_center / max(spsa_pairs, 1)
        g = {"center": g_center, "albedo": g_ad["albedo"] * mov}
        if fit_fuzz:
            g["fuzz"] = g_ad["fuzz"] * fuzz_mask
        updates, opt_state = opt.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state, key), loss

    @jax.jit
    def run(params, key):
        (params, _, _), losses = jax.lax.scan(
            one_step, (params, opt.init(params), key), None, length=steps)
        return params, losses

    t0 = time.time()
    params, losses = run(params0, jax.random.PRNGKey(seed + 101))
    losses = np.asarray(losses)
    wall = time.time() - t0

    result = FitResult(scene=_scene_of(params, params["center"]))
    result.losses = [float(l) for l in losses]
    result.step_seconds = [wall / max(steps, 1)] * steps
    return result
