"""The Whitted integrator, expressed as pure JAX over ray wavefronts.

Rebuild of ``Scene<AccStruct>::RayTrace`` (reference src/scene_inl.h:169-496,
compiled variant src/scene_trace.cpp:93-521) and ``TraceLight``
(scene_inl.h:89-167). The reference's recursive, per-4x4-block, per-material
re-shade batching becomes a branchless wavefront:

- the three shading fast paths (whole block one triangle / one material /
  per-material masked loop, scene_inl.h:253-430) collapse into gathers,
  which cost the same whether the block is uniform or not;
- secondary rays (reflection/transparency) are full wavefronts with masks
  (tmax < 0 sentinel) instead of RaySelector bitmasks; recursion is a
  statically unrolled bounce loop (the reference bounds it with
  ``cache.reflections < 1``, scene_inl.h:434);
- shadow rays keep the reference's exact geometry: traced FROM the light
  TOWARD the surface with shared origin (scene_inl.h:127-129), distance
  scaled by 0.9999 (scene_inl.h:122), masked by ``dot > 0``;
- the attenuation polynomial is reproduced bit-for-bit
  (scene_inl.h:150-152): atten = max(0, (1-d/r)*0.2 + 1/(16*(d/r)^2) -
  0.0625), diffuse += color * dot * atten, specular += color * dot^16 *
  atten (dot^16 via 4 squarings, scene_inl.h:155-160);
- final color = diffuse * lDiffuse + specular * lSpecular with ambient 0.1
  (scene_inl.h:480-487, scene.cpp:9).

Traversal is delegated to snail.ops (the CUDA kernel on a GPU, the jnp
reference elsewhere) or to a :class:`Tracer` such as the instance set of
scene/instancing.py; everything here is differentiable, with hit ids
treated as constants (see snail.diff).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.types import Light, RenderOpts
from ..core.vecmath import BIG, reflect
from ..ops import dispatch as ops_dispatch
from ..scene.materials import F_TEXCOORDS, F_TRANSPARENCY


def _gather(arr, idx):
    return jnp.take(arr, idx, axis=0)


class Tracer(NamedTuple):
    """Visibility queries the integrator shades over, when they are not
    the scene's own BVH (instanced scenes plug in here).

    closest_hit(orig, dirn, tmax) -> (dist, tri, bary, to_world), where
    ``to_world`` maps the scene's shading normals to world space (or None);
    any_hit_from(origin[3], dirn, tmax) -> blocked."""

    closest_hit: Callable
    any_hit_from: Callable


def shade_hits(scene, orig, dirn, dist, tri, bary, opts: RenderOpts,
               tile_hw=None, to_world=None):
    """Interpolate shading attributes at hits and evaluate materials.

    Returns a dict with position, normal, mat fields, diffuse/specular base
    colors, opacity — the wavefront version of ``shading::Sample``
    (reference src/shading/shading.h Sample struct usage in
    scene_inl.h:218-300).
    """
    hit = (dist > 0.0) & (dist < BIG)
    safe_tri = jnp.where(hit, tri, 0)
    u = bary[..., 0]
    v = bary[..., 1]

    # Miss rays carry dist = BIG (masked ones -BIG). Pushed through the
    # light, bounce and recompute math, that overflows to inf, and an
    # inf/nan value under a masked-out where still poisons the VJP
    # (0 cotangent x inf = nan). Their positions are never used, so
    # collapse them to the ray origin.
    pos = orig + dirn * jnp.where(hit, dist, 0.0)[..., None]
    # normal = n0 + ne1*u + ne2*v (scene_inl.h:279, 295)
    n = (
        _gather(scene.sh_n0, safe_tri)
        + _gather(scene.sh_ne1, safe_tri) * u[..., None]
        + _gather(scene.sh_ne2, safe_tri) * v[..., None]
    )
    if to_world is not None:
        n = to_world(n)
    uv = (
        _gather(scene.sh_uv0, safe_tri)
        + _gather(scene.sh_uve1, safe_tri) * u[..., None]
        + _gather(scene.sh_uve2, safe_tri) * v[..., None]
    )
    mat = jnp.where(hit, _gather(scene.sh_mat, safe_tri), 0)

    kd = _gather(scene.mat_diffuse, mat)
    ks = _gather(scene.mat_specular, mat)
    opacity = _gather(scene.mat_dissolve, mat)
    refl = _gather(scene.mat_reflect, mat)

    if opts.textures and scene.tex_atlas is not None:
        from ..scene.textures import (sample_atlas, sample_sat_atlas,
                                      uv_footprint)

        tex_id = _gather(scene.mat_difftex, mat)
        # uv footprint for mip selection (texDiff, scene_inl.h:294,
        # point_sampler.cpp:97-108): available when the wavefront is in
        # tile packet order (primary rays); bounces sample mip 0.
        diff_uv = (
            uv_footprint(uv, tile_hw, hit) if tile_hw is not None else None
        )
        if (opts.tex_filter == "sat" and scene.tex_sat is not None
                and diff_uv is not None):
            tex_rgb = sample_sat_atlas(scene.tex_sat, scene.tex_meta,
                                       tex_id, uv, diff_uv)
        else:
            tex_rgb = sample_atlas(scene.tex_atlas, scene.tex_meta, tex_id,
                                   uv, diff_uv,
                                   filter=("bilinear"
                                           if opts.tex_filter == "bilinear"
                                           else "point"))
        kd = jnp.where((tex_id >= 0)[..., None], tex_rgb, kd)
        diss_id = _gather(scene.mat_disstex, mat)
        diss_rgb = sample_atlas(scene.tex_atlas, scene.tex_meta, diss_id, uv)
        opacity = jnp.where(diss_id >= 0, diss_rgb[..., 0], opacity)

    # N.L-style view factor: Simple/Uber use |dir.n| (simple_material.h:19,
    # uber_material.h:16); TexMaterial omits the abs — we use abs uniformly.
    ndotd = jnp.abs(jnp.sum(dirn * n, axis=-1))
    diffuse = kd * ndotd[..., None]
    specular = ks

    zero = jnp.zeros_like(diffuse)
    return {
        "hit": hit,
        "pos": pos,
        "normal": n,
        "uv": uv,
        "mat": mat,
        "diffuse": jnp.where(hit[..., None], diffuse, zero),
        "specular": jnp.where(hit[..., None], specular, zero),
        "opacity": jnp.where(hit, opacity, 1.0),
        "reflect": jnp.where(hit, refl, 0.0),
    }


def trace_light(scene, samples, light_pos, light_color, light_radius,
                sel, opts: RenderOpts, tracer: Optional[Tracer] = None):
    """One light's diffuse/specular contribution with shadowing
    (reference TraceLight, scene_inl.h:89-167). ``sel`` masks live samples."""
    pos = samples["pos"]
    normal = samples["normal"]

    light_vec = pos - light_pos  # from light toward surface
    close = jnp.sum(light_vec * light_vec, axis=-1) < 1e-4
    light_vec = jnp.where(
        close[..., None], jnp.asarray([0.0, 1.0, 0.0]), light_vec
    )
    dist = jnp.sqrt(jnp.sum(light_vec * light_vec, axis=-1))
    from_light = light_vec / dist[..., None]
    dot = jnp.sum(normal * from_light, axis=-1)

    mask = sel & (dot > 0.0)
    if opts.shadows:
        tmax = jnp.where(mask, dist * 0.9999, -BIG)
        if tracer is None:
            blocked = ops_dispatch.any_hit_from(
                scene, light_pos, from_light, tmax
            )
        else:
            blocked = tracer.any_hit_from(light_pos, from_light, tmax)
        lit = mask & ~blocked
    else:
        lit = mask

    atten = dist * (1.0 / light_radius)
    atten = jnp.maximum(
        0.0, (1.0 - atten) * 0.2 + 1.0 / (16.0 * atten * atten) - 0.0625
    )
    diff_mul = dot * atten
    spec_mul = dot
    spec_mul = spec_mul * spec_mul
    spec_mul = spec_mul * spec_mul
    spec_mul = spec_mul * spec_mul
    spec_mul = spec_mul * spec_mul
    spec_mul = spec_mul * atten

    lit_f = lit[..., None]
    diffuse = jnp.where(lit_f, light_color * diff_mul[..., None], 0.0)
    specular = jnp.where(lit_f, light_color * spec_mul[..., None], 0.0)
    return diffuse, specular


def render_wavefront(scene, orig, dirn, tmax, opts: RenderOpts,
                     depth: int = 0, tile_hw=None, photon_grid=None,
                     tracer: Optional[Tracer] = None):
    """Trace + shade one wavefront; recurses (statically) for bounces.

    Returns color [R, 3]. This is RayTrace (scene_inl.h:169-496) minus the
    block bookkeeping. ``tile_hw`` (static (th, tw) or None) declares that
    the wavefront is in row-major tile packet order, enabling uv-footprint
    mip selection for the primary hit. ``tracer`` replaces the scene's
    own BVH for every visibility query of this wavefront and its bounces.
    """
    to_world = None
    if tracer is None:
        # Differentiable hit: traversal under stop_gradient + closed-form
        # recompute (snail.diff) so the whole integrator is
        # autodiffable.
        from ..diff.vjp import diff_closest_hit

        dist, tri, bary = diff_closest_hit(scene, orig, dirn, tmax)
    else:
        dist, tri, bary, to_world = tracer.closest_hit(orig, dirn, tmax)

    if not opts.shading:
        # gVals[4] distance view (scene_inl.h:204-212)
        idist = jnp.where(dist > 0.0, 1.0 / jnp.maximum(dist, 1e-6), 0.0)
        idist = jnp.where(dist >= BIG, 0.0, idist)
        return jnp.stack([idist * 20.0, idist * 250.0, idist * 2.0], axis=-1)

    samples = shade_hits(scene, orig, dirn, dist, tri, bary, opts,
                         tile_hw if depth == 0 else None, to_world)
    sel = samples["hit"] & (tmax >= 0.0)

    diffuse = samples["diffuse"]

    # --- reflections (scene_inl.h:434-444) ---
    if opts.reflections and depth < opts.max_bounces:
        # the wavefront is always traced; masked rays are cheap
        refl_sel = sel & (samples["reflect"] > 0.0)
        rdir = reflect(dirn, samples["normal"])
        rorig = samples["pos"] + rdir * 0.001
        rtmax = jnp.where(refl_sel, BIG, -BIG)
        refl_color = render_wavefront(
            scene, rorig, rdir, rtmax, opts, depth + 1,
            photon_grid=photon_grid, tracer=tracer
        )
        blend = samples["reflect"][..., None]
        diffuse = jnp.where(
            refl_sel[..., None],
            diffuse + (refl_color - diffuse) * blend,
            diffuse,
        )

    # --- transparency continuation (scene_inl.h:445-458; the reference
    # computes the machinery but disables the trace with `if(0&&...)`;
    # we enable it, gated by opts) ---
    if opts.transparency and depth < opts.max_bounces:
        trans_sel = sel & (samples["opacity"] < 1.0)
        torig = samples["pos"] + dirn * 0.1
        ttmax = jnp.where(trans_sel, BIG, -BIG)
        trans_color = render_wavefront(
            scene, torig, dirn, ttmax, opts, depth + 1,
            photon_grid=photon_grid, tracer=tracer
        )
        op = samples["opacity"][..., None]
        diffuse = jnp.where(
            trans_sel[..., None],
            trans_color + (diffuse - trans_color) * op,
            diffuse,
        )

    # --- lights (scene_inl.h:460-487) ---
    l_diffuse = jnp.full_like(diffuse, opts.ambient)
    l_specular = jnp.zeros_like(diffuse)
    lights: Optional[Light] = scene.lights
    if lights is not None:
        n_lights = lights.pos.shape[0]
        for i in range(n_lights):
            d, s = trace_light(
                scene,
                samples,
                lights.pos[i],
                lights.color[i],
                lights.radius[i],
                sel,
                opts,
                tracer,
            )
            l_diffuse = l_diffuse + d
            l_specular = l_specular + s

    # --- photon-map radiance (opt-in): gathered irradiance joins the
    # diffuse light sum, the wavefront form of the reference's photon
    # render variant (GatherPhotons during shading, photons.cpp:68-195;
    # scene_trace photon path). The dense-grid gather is the vectorized
    # estimator; tests pin it against the kd-tree oracle. ---
    if opts.photons and photon_grid is not None:
        from .photons import gather_photons_grid

        rad = gather_photons_grid(photon_grid, samples["pos"])
        l_diffuse = l_diffuse + rad * opts.photon_exposure

    color = diffuse * l_diffuse + samples["specular"] * l_specular
    return jnp.where(sel[..., None], color, jnp.zeros_like(color))
