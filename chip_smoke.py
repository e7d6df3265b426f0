#!/usr/bin/env python3
"""End-to-end smoke run of the renderer on one NVIDIA GPU.

Drives the main path once, at the sizes users render, through the entry
points a user calls, and checks every phase against the repository's plain
references:

  a. device     JAX must see a GPU; prints its kind, count, and the card's
                name and power limit (nvidia-smi)
  b. traversal  wide-BVH closest and any hit on the 327k-triangle mesh, with
                the regeneration driver (>= REGEN_MIN_B rays) and the
                majority+drain driver (below it), against a brute force over
                every triangle; shared-edge crack rate of the triangle test
  c. goldens    four scenes through parse_scene(...).scene.render() against
                the frozen CPU goldens in tests/goldens
  d. cli        utils/cli.main renders the bathroom at 1920x1080, 4 spp, to
                a PNG that must decode and not be black
  e. mesh       the textured 327k mesh at 1024^2, 8 spp, through Renderer;
                rays/s, peak device memory, and a profiler trace of one
                1-spp pass (device idle share, device-to-host copies)
  f. gradients  Cornell value_and_grad at 256^2 (bench.py's fwd+bwd step),
                and a central finite difference of one matte kd
  g. repeat     the same 1-spp pass twice; the max abs difference is
                reported, not asserted (film scatter-adds are atomics here)

Each phase prints one JSON line with its wall and compile seconds and every
compared number beside its tolerance; every rate carries the card's name and
power limit. A failed comparison or error ends the run with a non-zero exit
before the result line. The last line is the result:

  {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

--multi runs only the sharded path, on four GPUs: parallel/mesh.py's
render_sharded of the bathroom at 1080p, 4 spp, on meshes (data=4, sample=1)
and (data=2, sample=2) against the one-card Renderer image, and
make_sharded_train_step on the Cornell box with atlas imagemap walls at
256^2 against the one-card gradient. The training phase, the cheaper one,
runs first. Compile is most of a cold --multi run (three 1080p bathroom
programs of some minutes each): give it about 1200 s.

Usage: python chip_smoke.py [--multi]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# Golden tolerances per scene: (mean relative error, 99th-percentile
# relative error), as tests/test_golden.py gates the CPU render.
GOLDEN_TOLS = {
    "cornell-box": (2e-3, 2e-2),
    "veach-mis": (2e-3, 2e-2),
    "testball-textured": (2e-3, 2e-2),
    "envmap-dof": (2e-3, 2e-2),
}
# Traversal against the brute force on the same rays. Both run the same
# watertight test on the same vertex floats, so hits agree exactly up to
# FMA contraction in t; ids may differ only at ties (equal t).
TRAV_TOLS = {"hit_mismatch_frac": 1e-3, "t_rel_err_max": 1e-5,
             "tid_mismatch_frac": 1e-3, "anyhit_mismatch_frac": 1e-3}
TIE_REL = 1e-6           # |t_a - t_b| / t below this is a tie
CRACK_MISS_TOL = 2e-3    # tests/test_mesh.py's shared-edge miss-rate gate
FD_EPS, FD_RTOL, FD_ATOL = 1e-3, 2e-2, 1e-5   # tests/test_grad.py's matte kd
NOT_BLACK = 1e-4         # mean linear radiance of a lit frame
# Sharded against one card: the same sample set, summed in another order
# and by differently fused programs.
SHARD_TOLS = {"mean_rel": 2e-3, "p99_rel": 2e-2}
TRAIN_TOLS = {"loss_rel": 1e-4, "grad_err_rel": 1e-3}


# Full-size run
DRAGON_SUB = 7                 # 327,680-triangle hero mesh
DRAGON_RES, DRAGON_SPP = (1024, 1024), 8
MAX_LANES = 1 << 18
TRAV_RAYS = 1 << 18            # regeneration driver
TRAV_SMALL = 1 << 15           # majority+drain driver
TRAV_SAMPLE = 4096             # rays checked by brute force
CLI_RES, CLI_SPP = (1920, 1080), 4
FD_RES = (64, 64)
BATH_RES, BATH_SPP = (1920, 1080), 4
TRAIN_RES = (256, 256)


class PhaseFailed(RuntimeError):
    pass


class Phase:
    """One phase: times itself, records compared numbers beside their
    tolerances, prints one JSON line, and raises if a comparison failed."""

    def __init__(self, name: str, card: str):
        self.name = name
        self.card = card
        self.rec = {"phase": name}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def set(self, **fields):
        self.rec.update(fields)

    def rate(self, **rates):
        """Rates are only meaningful beside the card they ran on."""
        self.rec.update(rates)
        self.rec["card"] = self.card

    def compare(self, what: str, value, tol, op: str = "<="):
        value = float(value)
        ok = {"<=": value <= tol, "<": value < tol, ">=": value >= tol,
              ">": value > tol, "==": value == tol}[op]
        self.rec.setdefault("compared", {})[what] = {
            "value": value, "op": op, "tol": tol, "ok": bool(ok)}

    def __exit__(self, exc_type, exc, tb):
        self.rec["wall_s"] = time.perf_counter() - self.t0
        bad = [k for k, c in self.rec.get("compared", {}).items()
               if not c["ok"]]
        if exc_type is not None:
            self.rec["error"] = repr(exc)
        elif bad:
            self.rec["failed"] = bad
        print(json.dumps(self.rec), flush=True)
        if exc_type is None and bad:
            raise PhaseFailed(f"phase {self.name} failed: {bad}")
        return False


# ---------------------------------------------------------------------------
# comparison helpers (also run at tiny sizes by tests/test_chip_smoke.py)
# ---------------------------------------------------------------------------

def traversal_rays(cam, res, n, seed=0):
    """n rays, shuffled: half camera rays strided over the whole frame, half
    rays from random points in the scene's box in random directions, half
    of those with a finite t_max (shadow-ray style). → core.ray.Ray."""
    import jax.numpy as jnp
    import numpy as np
    from rustracer_tpu.core.ray import Ray

    rng = np.random.default_rng(seed)
    n_cam = n // 2
    xr, yr = res
    k = np.arange(n_cam, dtype=np.int64) * max(1, (xr * yr) // n_cam)
    k %= xr * yr
    p_film = np.stack([k % xr, k // xr], -1).astype(np.float32) + 0.5
    cam_ray = cam.generate_ray(jnp.asarray(p_film),
                               jnp.full((n_cam, 2), 0.5, jnp.float32))
    n_rnd = n - n_cam
    o = rng.uniform([-2.0, -1.2, -2.0], [2.0, 2.0, 2.0], (n_rnd, 3))
    d = rng.normal(size=(n_rnd, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.random(n_rnd) < 0.5, np.inf,
                     rng.uniform(0.2, 4.0, n_rnd))
    perm = rng.permutation(n)
    o_all = np.concatenate([np.asarray(cam_ray.o), o])[perm]
    d_all = np.concatenate([np.asarray(cam_ray.d), d])[perm]
    t_all = np.concatenate([np.asarray(cam_ray.t_max), t_max])[perm]
    return Ray(o=jnp.asarray(o_all, jnp.float32),
               d=jnp.asarray(d_all, jnp.float32),
               t_max=jnp.asarray(t_all, jnp.float32))


def brute_force_hits(tv_p, t_idx, ray, chunk=2048):
    """Closest hit of every ray over EVERY triangle → (hit, t, tid).

    Vectorised over (rays, chunk of triangles) with ops/triangle.py's
    watertight test, scanned over chunks; the lowest triangle id wins a
    tie, as in the traversal's leaf argmin."""
    import jax
    import jax.numpy as jnp
    from rustracer_tpu.ops.triangle import triangle_intersect

    n_tri = t_idx.shape[0]
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri
    # padding triangles are degenerate (three copies of vertex 0): no hits
    idx = jnp.concatenate([jnp.asarray(t_idx, jnp.int32),
                           jnp.zeros((pad, 3), jnp.int32)])
    tri = jnp.asarray(tv_p)[idx].reshape(n_chunks, chunk, 3, 3)
    base = jnp.arange(n_chunks, dtype=jnp.int32) * chunk

    @jax.jit
    def run(o, d, t_max, tri, base):
        def step(carry, xs):
            t_best, id_best = carry
            p, b = xs
            th = triangle_intersect(o[:, None], d[:, None], t_max[:, None],
                                    p[None, :, 0], p[None, :, 1],
                                    p[None, :, 2])
            tc = jnp.where(th.hit, th.t, jnp.inf)
            j = jnp.argmin(tc, axis=1)
            tj = jnp.take_along_axis(tc, j[:, None], axis=1)[:, 0]
            better = tj < t_best
            return (jnp.where(better, tj, t_best),
                    jnp.where(better, b + j.astype(jnp.int32), id_best)), None

        init = (jnp.full(o.shape[:1], jnp.inf, jnp.float32),
                jnp.full(o.shape[:1], -1, jnp.int32))
        (t, tid), _ = jax.lax.scan(step, init, (tri, base))
        return tid >= 0, t, tid

    return run(ray.o, ray.d, ray.t_max, tri, base)


def compare_hits(ref, got, any_hit=None):
    """Agreement of (hit, t, tid) with the brute-force reference."""
    import numpy as np
    h0, t0, i0 = (np.asarray(x) for x in ref)
    h1, t1, i1 = (np.asarray(x) for x in got)
    both = h0 & h1
    t_rel = np.zeros(t0.shape)
    t_rel[both] = np.abs(t1[both] - t0[both]) / np.maximum(np.abs(t0[both]),
                                                           1e-6)
    tid_bad = both & (i0 != i1) & (t_rel > TIE_REL)
    out = {"hit_frac": float(h0.mean()),
           "hit_mismatch_frac": float((h0 != h1).mean()),
           "t_rel_err_max": float(t_rel.max()) if t_rel.size else 0.0,
           "tid_mismatch_frac": float(tid_bad.mean())}
    if any_hit is not None:
        out["anyhit_mismatch_frac"] = float(
            (np.asarray(any_hit) != h0).mean())
    return out


def golden_compare(name, img):
    """(mean_rel, p99_rel) of a render against tests/goldens/<name>.npz."""
    import numpy as np
    from helpers import golden_error
    ref = np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz"))["img"]
    if img.shape != ref.shape:
        raise PhaseFailed(f"{name}: shape {img.shape} != golden {ref.shape}")
    return golden_error(img, ref)


def device_activity(fn):
    """Run fn() under the profiler and reduce the GPU plane of the trace.

    Busy time is the union of the event intervals on the device's stream
    lines; idle share is 1 - busy / (last event end - first event start).
    Also counts device-to-host copies and other device events (kernels).
    Fields are None when the trace has no GPU plane (a CPU run)."""
    import jax
    from jax.profiler import ProfileData

    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            fn()
            wall = time.perf_counter() - t0
        paths = glob.glob(os.path.join(d, "**", "*.xplane.pb"),
                          recursive=True)
        pd = ProfileData.from_file(paths[0])
        planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
        out = {"traced_wall_s": wall, "idle_share": None,
               "device_window_s": None, "device_busy_s": None,
               "d2h_copies": None, "device_events": None, "stream_lines": []}
        if not planes:
            return out
        spans, d2h, events = [], 0, 0
        for line in planes[0].lines:
            if not line.name.startswith("Stream"):
                continue
            out["stream_lines"].append(line.name)
            for ev in line.events:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                name = ev.name.lower()
                if "memcpy" in name and ("d2h" in name or "dtoh" in name):
                    d2h += 1
                else:
                    events += 1
    if not spans:
        return out
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    out.update(idle_share=1.0 - busy / window if window else None,
               device_window_s=window * 1e-9, device_busy_s=busy * 1e-9,
               d2h_copies=d2h, device_events=events)
    return out


def peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    """→ (JAX's device summary, the cards' nvidia-smi name and power
    limit). Stops the run unless JAX's backend is a GPU."""
    from rustracer_tpu.utils.device import card_label, require_gpu
    with Phase("a_device", None) as ph:
        dev = require_gpu("chip_smoke.py")
        card = card_label()
        ph.set(platform=dev["platform"], kind=dev["kind"],
               count=dev["count"], card=card)
    print(card, flush=True)
    return dev, card


def phase_traversal(card, scene):
    import jax
    from helpers import shared_edge_miss_rate
    from rustracer_tpu.accel import traverse16 as T
    from rustracer_tpu.core.ray import Ray

    with Phase("b_traversal", card) as ph:
        ctx, cam, n_tris, build_s = scene
        geom = ctx.geom
        rays = traversal_rays(cam, DRAGON_RES, TRAV_RAYS)
        small = Ray(o=rays.o[:TRAV_SMALL], d=rays.d[:TRAV_SMALL],
                    t_max=rays.t_max[:TRAV_SMALL])
        if not (TRAV_RAYS >= T.REGEN_MIN_B > TRAV_SMALL
                >= 4 * T.TAIL_FRACTION):
            raise PhaseFailed("ray counts do not select both drivers")
        t0 = time.perf_counter()
        progs = {}
        for label, r in (("regen", rays), ("drain", small)):
            for kind, fn in (("closest", T.bvh16_intersect_triangles),
                             ("any", T.bvh16_intersect_p_triangles)):
                progs[label, kind] = jax.jit(fn).lower(geom, r).compile()
        compile_s = time.perf_counter() - t0
        out = {}
        for label, r in (("regen", rays), ("drain", small)):
            out[label] = (jax.block_until_ready(progs[label, "closest"](geom, r)),
                          jax.block_until_ready(progs[label, "any"](geom, r)))
        t0 = time.perf_counter()
        jax.block_until_ready(progs["regen", "closest"](geom, rays))
        closest_s = time.perf_counter() - t0

        S = TRAV_SAMPLE
        sample = Ray(o=rays.o[:S], d=rays.d[:S], t_max=rays.t_max[:S])
        t0 = time.perf_counter()
        ref = jax.block_until_ready(
            brute_force_hits(geom.tv_p, geom.t_idx, sample))
        brute_s = time.perf_counter() - t0
        for label, ((hit, t, tid), anyhit) in out.items():
            m = compare_hits(ref, (hit[:S], t[:S], tid[:S]), anyhit[:S])
            ph.set(**{f"{label}_hit_frac": m.pop("hit_frac")})
            for k, v in m.items():
                ph.compare(f"{label}_{k}", v, TRAV_TOLS[k])
        miss, covered = shared_edge_miss_rate(n=4096)
        ph.compare("crack_miss_rate", miss, CRACK_MISS_TOL, "<")
        ph.compare("crack_rays_covered", covered, 4096 // 2, ">")
        ph.set(triangles=int(n_tris), scene_build_s=build_s,
               rays=TRAV_RAYS, small_rays=TRAV_SMALL,
               regen_min_b=T.REGEN_MIN_B, sample=S, compile_s=compile_s,
               brute_force_s=brute_s)
        ph.rate(closest_hit_rays_per_s=TRAV_RAYS / closest_s)


def phase_goldens(card):
    import numpy as np
    from rustracer_tpu.scene.api import parse_scene
    from rustracer_tpu.utils import stats as S

    for name in GOLDEN_TOLS:
        mean_tol, p99_tol = GOLDEN_TOLS[name]
        with Phase(f"c_golden_{name}", card) as ph:
            S.init_stats()
            api = parse_scene(os.path.join(REPO, "scenes", f"{name}.pbrt"))
            img = np.asarray(api.scene.render())
            ph.compare("nonfinite_pixels", (~np.isfinite(img)).sum(), 0,
                       "==")
            mean_rel, p99_rel = golden_compare(name, img)
            ph.compare("mean_rel", mean_rel, mean_tol, "<")
            ph.compare("p99_rel", p99_rel, p99_tol, "<")
            ph.set(compile_s=S.phases().get("render/compile (first step)"),
                   shape=list(img.shape))


def phase_cli(card):
    import bench
    from rustracer_tpu.render.imageio import read_png8
    from rustracer_tpu.utils import cli
    from rustracer_tpu.utils import stats as S

    with Phase("d_cli", card) as ph, tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "bathroom.pbrt")
        bench.write_bathroom_scene(scene, CLI_RES)
        out = os.path.join(tmp, "bathroom.png")
        lanes_log2 = MAX_LANES.bit_length() - 1
        rc = cli.main([scene, "--spp", str(CLI_SPP), "-o", out,
                       "-t", str(lanes_log2)])
        ph.compare("cli_exit_code", rc, 0, "==")
        png = read_png8(out)
        w, h = CLI_RES
        ph.compare("png_rows", png.shape[0], h, "==")
        ph.compare("png_cols", png.shape[1], w, "==")
        ph.compare("png_mean_8bit", png.mean(), 1.0, ">=")
        phases = S.phases()
        compile_s = phases.get("render/compile (first step)")
        steady_s = phases.get("render/steady")
        first = min(MAX_LANES, w * h)
        ph.set(compile_s=compile_s, steady_s=steady_s, res=[w, h],
               spp=CLI_SPP, max_lanes=MAX_LANES,
               compile_note="first step: trace + compile + one step")
        ph.rate(camera_rays_per_s=(w * h * CLI_SPP - first) / steady_s)


def phase_mesh(card, scene):
    import jax
    import numpy as np
    from rustracer_tpu.render.renderer import RenderConfig, Renderer

    with Phase("e_mesh", card) as ph:
        ctx, cam, film, sampler, integ = scene
        r = Renderer(integ.li, cam, film, sampler,
                     RenderConfig(max_lanes=MAX_LANES,
                                  collect_stats=False))
        t0 = time.perf_counter()
        jax.block_until_ready(r.render_state(ctx, sample_stop=1))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fs = r.render_state(ctx, sample_stop=DRAGON_SPP)
        img = np.asarray(film.to_image(fs))
        full_s = time.perf_counter() - t0
        ph.compare("nonfinite_pixels", (~np.isfinite(img)).sum(), 0, "==")
        ph.compare("mean_radiance", img.mean(), NOT_BLACK, ">")
        xr, yr = DRAGON_RES
        steps = -(-xr * yr // MAX_LANES)
        act = device_activity(lambda: jax.block_until_ready(
            r.render_state(ctx, sample_stop=1)))
        per_step = {k: act[k] / steps for k in ("d2h_copies", "device_events")
                    if act[k] is not None}
        ph.set(compile_s=first_s - full_s / DRAGON_SPP,
               compile_note="first 1-spp pass minus a steady 1-spp pass",
               res=list(DRAGON_RES), spp=DRAGON_SPP,
               max_lanes=MAX_LANES, render_s=full_s,
               peak_bytes_in_use=peak_bytes(), trace=act,
               trace_steps=steps, trace_per_step=per_step)
        ph.rate(camera_rays_per_s=xr * yr * DRAGON_SPP / full_s)
    return r


def phase_gradients(card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import bench
    from helpers import cornell_camera
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter

    with Phase("f_gradients", card) as ph:
        ctx, cam, film, sampler, integ = bench.build_cornell()
        vg, n_rays = bench.make_cornell_fwdbwd(ctx, cam, film, sampler, integ)
        t0 = time.perf_counter()
        loss, grads = jax.block_until_ready(vg(ctx.textures))
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, grads = jax.block_until_ready(vg(ctx.textures))
        step_s = time.perf_counter() - t0
        leaves = [np.asarray(g) for g in jax.tree.leaves(grads)]
        ph.compare("loss_nonfinite", 0 if np.isfinite(float(loss)) else 1,
                   0, "==")
        ph.compare("grad_nonfinite",
                   sum(int((~np.isfinite(g)).sum()) for g in leaves), 0, "==")
        ph.compare("grad_max_abs", max(float(np.abs(g).max())
                                       for g in leaves), 0.0, ">")

        # finite difference of d loss / d kd0 (white walls) per channel, on
        # a depth-3 integrator: no Russian roulette, so every sampling
        # decision is detached from kd and FD converges to the gradient
        res = FD_RES
        integ3 = dataclasses.replace(integ, max_depth=3)
        film3 = Film(full_resolution=res, filter=Filter("box", 0.5, 0.5))
        vg3, _ = bench.make_cornell_fwdbwd(ctx, cornell_camera(res), film3,
                                           sampler, integ3)
        kd0 = np.asarray(ctx.textures["const"]["kd0"])

        def with_kd0(v):
            const = dict(ctx.textures["const"], kd0=jnp.asarray(v))
            return {**ctx.textures, "const": const}

        t0 = time.perf_counter()
        _, g3 = jax.block_until_ready(vg3(ctx.textures))
        fd_compile_s = time.perf_counter() - t0
        g = np.asarray(g3["const"]["kd0"])
        for c in range(3):
            lp = float(vg3(with_kd0(kd0 + FD_EPS * np.eye(3)[c]))[0])
            lm = float(vg3(with_kd0(kd0 - FD_EPS * np.eye(3)[c]))[0])
            fd = (lp - lm) / (2 * FD_EPS)
            ph.compare(f"fd_kd0_c{c}_abs_err", abs(g[c] - fd),
                       FD_ATOL + FD_RTOL * abs(fd))
            ph.set(**{f"fd_kd0_c{c}": {"grad": float(g[c]), "fd": fd}})
        ph.set(compile_s=first_s - step_s, fd_compile_s=fd_compile_s,
               loss=float(loss), res=list(film.full_resolution),
               fd_res=list(res), fd_eps=FD_EPS, step_s=step_s)
        ph.rate(fwdbwd_rays_per_s=n_rays / step_s)


def phase_repeat(card, scene, renderer):
    import jax
    import numpy as np

    with Phase("g_repeat", card) as ph:
        ctx, film = scene[0], scene[2]
        a = np.asarray(film.to_image(jax.block_until_ready(
            renderer.render_state(ctx, sample_stop=1))))
        b = np.asarray(film.to_image(jax.block_until_ready(
            renderer.render_state(ctx, sample_stop=1))))
        diff = np.abs(a - b)
        ph.set(max_abs_diff=float(diff.max()),
               differing_pixels=int((diff.max(-1) > 0).sum()),
               mean_abs=float(np.abs(a).mean()),
               note="reported, not asserted: film scatter-adds are "
                    "atomics on the GPU")


def run_single(card):
    import bench

    t0 = time.perf_counter()
    ctx, cam, film, sampler, integ, n_tris = bench.build_dragon(
        sub=DRAGON_SUB, res=DRAGON_RES, spp=DRAGON_SPP)
    build_s = time.perf_counter() - t0
    phase_traversal(card, (ctx, cam, n_tris, build_s))
    phase_goldens(card)
    phase_cli(card)
    scene = (ctx, cam, film, sampler, integ)
    renderer = phase_mesh(card, scene)
    phase_gradients(card)
    phase_repeat(card, scene, renderer)


def _timed(ph, key, fn):
    """fn() → its result; its wall seconds go into the phase record under
    `key` and, as it finishes, to stderr, so a run cut at its time limit
    still shows how far it got."""
    t0 = time.perf_counter()
    out = fn()
    ph.set(**{key: time.perf_counter() - t0})
    print(f"[{ph.name}] {key} {ph.rec[key]:.1f}", file=sys.stderr,
          flush=True)
    return out


def phase_train_sharded(card):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import __graft_entry__ as graft
    from helpers import frame_lanes, single_device_train_loss
    from rustracer_tpu.parallel.mesh import (make_device_mesh,
                                             make_sharded_train_step)

    with Phase("m_train_sharded", card) as ph:
        ctx, cam, film, sampler, integ = graft._cornell_setup(
            res=TRAIN_RES, spp=2, imagemaps=True)
        mesh = make_device_mesh(data=2, sample=2)
        px, py, valid = frame_lanes(film, mesh.shape["data"])
        loss_fn, tex_f = single_device_train_loss(
            ctx, cam, film, sampler, integ, px, py, valid,
            mesh.shape["sample"])
        target = jnp.zeros(tuple(TRAIN_RES[::-1]) + (3,), jnp.float32)
        lr = 0.25
        train = make_sharded_train_step(integ.li, cam, film, sampler, mesh,
                                        lr=lr)
        loss_1, g1 = _timed(ph, "one_card_s", lambda: jax.block_until_ready(
            jax.jit(jax.value_and_grad(loss_fn))(tex_f, target)))
        new_ctx, loss_n = _timed(ph, "sharded_s", lambda: (
            jax.block_until_ready(train(ctx, target, px, py, valid,
                                        jnp.uint32(0)))))
        new_f = {k: new_ctx.textures[k] for k in tex_f}
        gn = jax.tree.map(lambda p, q: (p - q) / lr, tex_f, new_f)
        g1l = [np.asarray(x) for x in jax.tree.leaves(g1)]
        gnl = [np.asarray(x) for x in jax.tree.leaves(gn)]
        gmax = max(float(np.abs(x).max()) for x in g1l)
        err = max(float(np.abs(a - b).max()) for a, b in zip(g1l, gnl))
        ph.compare("grad_max_abs", gmax, 0.0, ">")
        ph.compare("loss_rel", abs(float(loss_n) - float(loss_1))
                   / abs(float(loss_1)), TRAIN_TOLS["loss_rel"])
        ph.compare("grad_err_rel", err / gmax, TRAIN_TOLS["grad_err_rel"])
        ph.set(loss=float(loss_1), res=list(TRAIN_RES), mesh=[2, 2],
               lr=lr, note="grad_err_rel = max |g_sharded - g_one| / "
                           "max |g_one|; sharded grads read back from the "
                           "SGD update; seconds include trace and compile")


def phase_render_sharded(card):
    import jax
    import numpy as np
    import bench
    from helpers import golden_error
    from rustracer_tpu.parallel.mesh import make_device_mesh, render_sharded
    from rustracer_tpu.render.renderer import RenderConfig, Renderer

    with Phase("m_render_sharded", card) as ph:
        ctx, cam, film, sampler, integ = _timed(
            ph, "build_s", lambda: bench.build_bathroom(BATH_RES))
        sampler = dataclasses.replace(sampler, spp=BATH_SPP)
        single = _timed(ph, "one_card_s", lambda: np.asarray(Renderer(
            integ.li, cam, film, sampler,
            RenderConfig(max_lanes=MAX_LANES, collect_stats=False)
        ).render(ctx)))
        ph.compare("one_card_mean_radiance", single.mean(), NOT_BLACK, ">")
        for data, sample in ((4, 1), (2, 2)):
            tag = f"mesh_{data}x{sample}"
            mesh = make_device_mesh(data=data, sample=sample)
            img = _timed(ph, f"{tag}_s", lambda: np.asarray(
                jax.block_until_ready(render_sharded(
                    ctx, integ.li, cam, film, sampler, mesh,
                    max_lanes=MAX_LANES))))
            ph.set(**{f"{tag}_max_abs": float(np.abs(img - single).max())})
            ph.compare(f"{tag}_nonfinite", (~np.isfinite(img)).sum(), 0,
                       "==")
            mean_rel, p99_rel = golden_error(img, single)
            ph.compare(f"{tag}_mean_rel", mean_rel, SHARD_TOLS["mean_rel"],
                       "<")
            ph.compare(f"{tag}_p99_rel", p99_rel, SHARD_TOLS["p99_rel"], "<")
        ph.set(res=list(BATH_RES), spp=BATH_SPP, max_lanes=MAX_LANES,
               note="render seconds include trace and compile")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="End-to-end GPU smoke run of the renderer")
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded render and training step "
                         "on four GPUs, against one-card results")
    args = ap.parse_args(argv)

    from rustracer_tpu.utils.device import configure_compile_cache
    configure_compile_cache()
    dev, card = phase_device()
    if args.multi:
        if dev["count"] != 4:
            raise SystemExit(f"--multi needs four GPUs; JAX found "
                             f"{dev['count']}")
        phase_train_sharded(card)
        phase_render_sharded(card)
    else:
        run_single(card)
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
