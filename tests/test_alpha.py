"""Alpha-mask textures on triangle meshes.

Reference: shapes/mesh.rs — alpha_mask rejects intersections whose alpha
texture evaluates to 0 (mesh.rs:355-367); shadow rays additionally honor
shadow_alpha_mask (mesh.rs:572-577); both resolve from "alpha"/"shadowalpha"
params (mesh.rs:134-156). Wavefront redesign: textures are baked to an alpha atlas
(bundle.py::_bake_alpha) and rejected hits re-trace from just past the
cutout (tables.py::_closest_with_alpha).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from helpers import TriBuilder
from rustracer_tpu.core.ray import Ray
from rustracer_tpu.scene.tables import (make_geometry, scene_intersect,
                                        scene_intersect_p)


def _alpha_scene(with_bvh, shadow_all_zero=False):
    """Masked quad at z=0 (left half alpha 0, right half 1) + solid wall
    at z=1."""
    tb = TriBuilder()
    tb.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), material=0)
    tb.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1), material=0)
    tris = tb.build()
    tris["t_alpha_tex"] = np.array([0, 0, -1, -1], np.int32)
    if shadow_all_zero:
        tris["t_shadow_alpha_tex"] = np.array([1, 1, -1, -1], np.int32)
    # map 0: 4x4, left half 0, right half 1; map 1: all zeros
    m0 = np.zeros((4, 4), np.float32)
    m0[:, 2:] = 1.0
    m1 = np.zeros((4, 4), np.float32)
    alpha = dict(alpha_atlas=np.concatenate([m0.ravel(), m1.ravel()]),
                 alpha_meta=np.array([[0, 4, 4], [16, 4, 4]], np.int32))
    bvh = None
    if with_bvh:
        from rustracer_tpu.accel.bvh import build_bvh_arrays
        bvh = build_bvh_arrays(None, tris)
    return make_geometry(tris=tris, bvh=bvh, alpha=alpha)


def _rays(xs, t_max=np.inf):
    n = len(xs)
    o = np.stack([np.asarray(xs, np.float32),
                  np.full(n, 0.5, np.float32),
                  np.full(n, -1.0, np.float32)], -1)
    d = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    return Ray(o=jnp.asarray(o), d=jnp.asarray(d),
               t_max=jnp.full(n, t_max, jnp.float32))


@pytest.mark.parametrize("with_bvh", [False, True])
class TestAlphaMask:
    def test_camera_rays_pass_through_cutout(self, with_bvh):
        geom = _alpha_scene(with_bvh)
        si = scene_intersect(geom, _rays([0.25, 0.75]))
        t = np.asarray(si.t)
        assert np.asarray(si.valid).all()
        # x=0.25: alpha 0 → punches through to the wall at t=2
        assert t[0] == pytest.approx(2.0, rel=1e-3)
        # x=0.75: alpha 1 → hits the masked quad at t=1
        assert t[1] == pytest.approx(1.0, rel=1e-3)

    def test_shadow_rays_honor_alpha(self, with_bvh):
        geom = _alpha_scene(with_bvh)
        # t_max 1.5: only the masked quad is in range
        occ = np.asarray(scene_intersect_p(geom, _rays([0.25, 0.75],
                                                       t_max=1.5)))
        assert not occ[0]   # hole
        assert occ[1]       # opaque half

    def test_shadowalpha_overrides_shadow_rays(self, with_bvh):
        """shadowalpha all-zero: shadow rays pass everywhere, camera rays
        still respect the regular alpha mask (mesh.rs:572-577)."""
        geom = _alpha_scene(with_bvh, shadow_all_zero=True)
        occ = np.asarray(scene_intersect_p(geom, _rays([0.25, 0.75],
                                                       t_max=1.5)))
        assert not occ.any()
        si = scene_intersect(geom, _rays([0.75]))
        assert np.asarray(si.t)[0] == pytest.approx(1.0, rel=1e-3)

    def test_no_alpha_unaffected(self, with_bvh):
        """Same scene without masks: both rays hit the front quad."""
        tb = TriBuilder()
        tb.add_quad((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0))
        tb.add_quad((0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
        tris = tb.build()
        bvh = None
        if with_bvh:
            from rustracer_tpu.accel.bvh import build_bvh_arrays
            bvh = build_bvh_arrays(None, tris)
        geom = make_geometry(tris=tris, bvh=bvh)
        assert not geom.has_alpha
        si = scene_intersect(geom, _rays([0.25, 0.75]))
        np.testing.assert_allclose(np.asarray(si.t), 1.0, rtol=1e-3)


def test_alpha_through_parser(tmp_path):
    """End-to-end: imagemap alpha via the .pbrt front-end — light reaches
    the floor through the cutout and is blocked by the opaque half."""
    from rustracer_tpu.render.imageio import write_image
    from rustracer_tpu.scene.api import parse_scene_string

    mask = np.zeros((4, 4, 3), np.float32)
    mask[:, 2:, :] = 1.0
    png = str(tmp_path / "mask.png")
    write_image(png, mask)

    scene = f"""
Film "image" "integer xresolution" [32] "integer yresolution" [16]
Camera "perspective" "float fov" [50]
Sampler "02sequence" "integer pixelsamples" [4]
Integrator "directlighting"
WorldBegin
  LightSource "point" "rgb I" [40 40 40] "point from" [0 3 0]
  Texture "mask" "float" "imagemap" "string filename" "{png}"
  AttributeBegin
    Material "matte" "rgb Kd" [0.8 0.8 0.8]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-2 1.5 -2   2 1.5 -2   2 1.5 2   -2 1.5 2]
      "float uv" [0 0  1 0  1 1  0 1]
      "texture alpha" "mask"
  AttributeEnd
  Material "matte" "rgb Kd" [0.8 0.8 0.8]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-4 0 -4   4 0 -4   4 0 4   -4 0 4]
WorldEnd
"""
    api = parse_scene_string(scene, options={"camera_override": None})
    # camera looks straight down at the floor from above is awkward via
    # LookAt defaults; render with the scene's camera (identity → +z);
    # instead probe the tables directly for shadow behaviour:
    geom = api.scene.geom
    assert geom.has_alpha
    from rustracer_tpu.core.ray import Ray
    # shadow probes from the floor straight up to the light: the masked
    # quad at y=1.5 spans x,z in [-2,2] with u = (x+2)/4 → u<0.5 is the hole
    o = np.array([[-1.0, 0.01, 0.0], [1.0, 0.01, 0.0]], np.float32)
    d = np.tile(np.array([0, 1, 0], np.float32), (2, 1))
    occ = np.asarray(scene_intersect_p(geom, Ray(
        o=jnp.asarray(o), d=jnp.asarray(d), t_max=jnp.full(2, 10.0))))
    assert not occ[0]   # under the cutout half
    assert occ[1]       # under the opaque half
