"""Bench-scene construction guards (bench.py and chip_smoke.py build it).

Round-4 lesson: the dragon light quad was wound so its one-sided emitter
faced AWAY from the scene for two rounds — renders were black and nothing
checked. These tests pin the scene geometry without rendering."""
import sys
import os

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_dragon_light_faces_scene():
    import bench
    ctx, cam, film, sampler, integ, n_tris = bench.build_dragon()
    g = ctx.geom
    t_idx = np.asarray(g.t_idx)
    tv_p = np.asarray(g.tv_p)
    lights = np.where(np.asarray(g.t_arealight) >= 0)[0]
    assert len(lights) == 2
    for ti in lights:
        p0, p1, p2 = tv_p[t_idx[ti]]
        ng = np.cross(p1 - p0, p2 - p0)
        ng /= np.linalg.norm(ng)
        # emitter at y=3 must face DOWN toward the scene below
        assert ng[1] < -0.9, f"light tri {ti} normal {ng} faces away"
    # and the lights sit above both the mesh and the ground
    assert tv_p[t_idx[lights[0]]][:, 1].min() > 2.0



def test_dragon_bvh_cache_roundtrip(tmp_path, monkeypatch):
    """The bench BVH file cache must reproduce the built tables exactly
    (a wrong cache would silently benchmark wrong geometry), and by default
    lives inside the checkout."""
    import bench
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.dirname(bench.BVH_CACHE_DIR) == repo
    monkeypatch.setattr(bench, "BVH_CACHE_DIR", str(tmp_path))
    # small mesh for speed; ply_roundtrip off
    ctx1, *_ = bench.build_dragon(sub=4, res=(32, 32), spp=1,
                                  ply_roundtrip=False)
    caches = list(tmp_path.glob("bvh_4_*.npz"))
    assert caches, "cache file not written"
    ctx2, *_ = bench.build_dragon(sub=4, res=(32, 32), spp=1,
                                  ply_roundtrip=False)   # cache hit
    np.testing.assert_array_equal(np.asarray(ctx1.geom.bvh16_table),
                                  np.asarray(ctx2.geom.bvh16_table))
    np.testing.assert_array_equal(np.asarray(ctx1.geom.bvh16_roots),
                                  np.asarray(ctx2.geom.bvh16_roots))
