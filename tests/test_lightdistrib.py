"""SpatialLightDistribution (dense-grid redesign of lightdistrib.rs).

Checks: PMF validity, proximity weighting (a voxel next to a point light
prefers that light), CDF-inversion sampling statistics, and that the path
integrator's spatial strategy stays unbiased vs the uniform strategy.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import cornell_box, cornell_camera
from rustracer_tpu.scene import lightdistrib as LD
from rustracer_tpu.scene import lights as L
from rustracer_tpu.scene.tables import make_geometry


def _two_point_lights_grid():
    # empty geometry (dummy quadric only), two point lights at opposite ends
    geom = make_geometry()
    rows = [dict(type=L.LIGHT_POINT, pos=(0.1, 0.5, 0.5), emit=(10, 10, 10)),
            dict(type=L.LIGHT_POINT, pos=(0.9, 0.5, 0.5), emit=(10, 10, 10))]
    lt = L.make_lights(rows, world_center=(0.5, 0.5, 0.5), world_radius=1.0)
    grid = LD.build_spatial_grid(lt, geom, (0, 0, 0), (1, 1, 1),
                                 max_voxels=8, n_samples=32)
    return lt, geom, grid


def test_grid_pmf_valid_and_proximity_weighted():
    _, _, grid = _two_point_lights_grid()
    pmf = np.asarray(grid.pmf)
    assert pmf.shape[-1] == 2
    assert np.all(pmf > 0.0)  # min-contrib floor (lightdistrib.rs:157-170)
    np.testing.assert_allclose(pmf.sum(-1), 1.0, rtol=1e-5)
    # a point near light 0 should strongly prefer it, and vice versa
    lid0, p0 = LD.sample_light(grid, jnp.array([0.1, 0.5, 0.5]),
                               jnp.array(0.0))
    assert int(lid0) == 0
    pmf0 = np.asarray(grid.pmf)[_flat(grid, (0.1, 0.5, 0.5))]
    pmf1 = np.asarray(grid.pmf)[_flat(grid, (0.9, 0.5, 0.5))]
    assert pmf0[0] > 0.9
    assert pmf1[1] > 0.9


def _flat(grid, p):
    off = (np.asarray(p) - np.asarray(grid.world_lo)) * \
        np.asarray(grid.world_inv_ext)
    nv = np.asarray(grid.n_voxels)
    vi = np.clip((off * nv).astype(np.int32), 0, nv - 1)
    return int(np.dot(vi, np.asarray(grid.strides)))


def test_sample_light_statistics_match_pmf():
    _, _, grid = _two_point_lights_grid()
    p = jnp.broadcast_to(jnp.array([0.5, 0.5, 0.5]), (4096, 3))
    u = jnp.linspace(0.0, 0.999999, 4096)
    lid, pmf = LD.sample_light(grid, p, u)
    frac1 = float(jnp.mean((lid == 1).astype(jnp.float32)))
    want = float(np.asarray(grid.pmf)[_flat(grid, (0.5, 0.5, 0.5))][1])
    assert abs(frac1 - want) < 0.01
    # reported pmf must match the picked row entry
    rows = np.asarray(grid.pmf)[_flat(grid, (0.5, 0.5, 0.5))]
    np.testing.assert_allclose(np.asarray(pmf), rows[np.asarray(lid)],
                               rtol=1e-6)


@pytest.mark.slow
def test_path_spatial_strategy_unbiased_vs_uniform():
    from rustracer_tpu.render.film import Film
    from rustracer_tpu.render.filters import Filter
    from rustracer_tpu.render.renderer import RenderContext, render
    from rustracer_tpu.render.sampler import SamplerConfig
    from rustracer_tpu.integrators.path import PathIntegrator
    from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
    from rustracer_tpu.scene.textures import ConstantTexture

    geom, lights = cornell_box()
    ms = MaterialSet()
    const = {}
    for i, a in enumerate([[0.7] * 3, [0.6, 0.05, 0.05],
                           [0.05, 0.6, 0.05], [0.0] * 3]):
        const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
        ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
    textures = {"const": const, "images": []}
    grid = LD.build_spatial_grid(lights, geom, (0, 0, 0), (1, 1, 1),
                                 max_voxels=4, n_samples=32)
    cam = cornell_camera(res=(24, 24))
    integ = PathIntegrator(mat_set=ms, max_depth=3)
    film = Film(full_resolution=(24, 24), filter=Filter("box", 0.5, 0.5))
    samp = SamplerConfig(kind="02sequence", spp=64)

    imgs = {}
    for name, lg in (("uniform", None), ("spatial", grid)):
        ctx = RenderContext(geom=geom, lights=lights, textures=textures,
                            light_grid=lg)
        imgs[name] = np.asarray(render(ctx, integ.li, cam, film, samp))
    mean_u = imgs["uniform"].mean()
    mean_s = imgs["spatial"].mean()
    assert abs(mean_s - mean_u) / mean_u < 0.05
    # pixelwise agreement within Monte-Carlo noise
    diff = np.abs(imgs["spatial"] - imgs["uniform"]).mean()
    assert diff / mean_u < 0.25
