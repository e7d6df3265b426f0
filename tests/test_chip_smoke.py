"""chip_smoke.py and utils/device.py on the CPU: the device guard, the
compile-cache helper, and the comparison helpers at tiny sizes. The GPU
run itself is `python chip_smoke.py` on a machine with the card."""
import ast
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from rustracer_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, **env):
    e = {k: v for k, v in os.environ.items() if k != device.CACHE_ENV}
    e.update(JAX_PLATFORMS="cpu", **env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv", [[], ["--multi"]], ids=["one", "multi"])
def test_device_guard_refuses_cpu(argv):
    r = _run([os.path.join(REPO, "chip_smoke.py")] + argv, REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_script_alone_fails(tmp_path):
    """Without the repository beside it the script cannot run anything."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        device.require_gpu("test")


_CACHE_PROBE = """
import json, jax
before = dict(jax.config.values)
from rustracer_tpu.utils.device import configure_compile_cache
used = configure_compile_cache()
after = dict(jax.config.values)
print(json.dumps({"used": used,
                  "changed": sorted(k for k in after
                                    if after[k] != before.get(k)),
                  "dir": jax.config.jax_compilation_cache_dir}))
"""


def test_cache_default_inside_checkout():
    r = _run(["-c", _CACHE_PROBE], REPO)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["used"] == out["dir"] == os.path.join(REPO, ".jax_cache")
    assert out["changed"] == ["jax_compilation_cache_dir"]


def test_cache_env_var_honoured(tmp_path):
    r = _run(["-c", _CACHE_PROBE], REPO,
             JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["used"] == out["dir"] == str(tmp_path)
    assert out["changed"] == []          # JAX read the variable itself


def test_cache_dir_is_git_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    rel = os.path.relpath(device.DEFAULT_CACHE_DIR, REPO)
    assert rel + "/" in ignored and not rel.startswith("..")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def _program_files():
    for root in ("rustracer_tpu", "tools"):
        for d, _, files in os.walk(os.path.join(REPO, root)):
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))
    yield os.path.join(REPO, "bench.py")
    yield os.path.join(REPO, "chip_smoke.py")


# Pallas's TPU backend module, as the parts of its dotted name
TPU_PALLAS = ("jax", "experimental", "pallas", "tpu")


def test_no_pil_or_tpu_pallas_imports():
    bad = [(os.path.relpath(p, REPO), m) for p in _program_files()
           for m in _imports(p)
           if m.split(".")[0] == "PIL"
           or tuple(m.split(".")[:4]) == TPU_PALLAS]
    assert not bad


def test_phase_records_and_raises(capsys):
    with pytest.raises(cs.PhaseFailed):
        with cs.Phase("x", "card A, 700.00 W") as ph:
            ph.compare("small", 1.0, 2.0)
            ph.compare("big", 3.0, 2.0)
            ph.rate(rays_per_s=5.0)
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["failed"] == ["big"] and rec["card"] == "card A, 700.00 W"
    assert rec["compared"]["small"] == {"value": 1.0, "op": "<=", "tol": 2.0,
                                        "ok": True}


def test_compare_hits_counts_ties_and_mismatches():
    ref = (np.array([1, 1, 1, 0, 1], bool),
           np.array([1.0, 2.0, 3.0, np.inf, 5.0], np.float32),
           np.array([0, 1, 2, 0, 4]))
    got = (np.array([1, 1, 1, 0, 0], bool),
           np.array([1.0, 2.0, 3.5, np.inf, np.inf], np.float32),
           np.array([0, 7, 9, 0, 0]))   # 7: a tie at t=2; 9: a real miss
    m = cs.compare_hits(ref, got, any_hit=np.array([1, 1, 1, 1, 1], bool))
    assert m["hit_mismatch_frac"] == pytest.approx(0.2)
    assert m["tid_mismatch_frac"] == pytest.approx(0.2)
    assert m["t_rel_err_max"] == pytest.approx(0.5 / 3.0)
    assert m["anyhit_mismatch_frac"] == pytest.approx(0.2)


@pytest.fixture(scope="module")
def small_dragon():
    import bench
    return bench.build_dragon(sub=2, res=(32, 32), spp=1,
                              ply_roundtrip=False)


def test_brute_force_matches_fori_reference(small_dragon):
    """The chunked brute force agrees with the scene tables' per-triangle
    loop (two independent references)."""
    from rustracer_tpu.scene.tables import intersect_triangles_brute
    ctx, cam = small_dragon[0], small_dragon[1]
    rays = cs.traversal_rays(cam, (32, 32), 512, seed=1)
    got = cs.brute_force_hits(ctx.geom.tv_p, ctx.geom.t_idx, rays, chunk=64)
    ref = jax.jit(intersect_triangles_brute)(ctx.geom, rays)
    m = cs.compare_hits(ref, got)
    assert 0.2 < m["hit_frac"] < 0.95
    assert m["hit_mismatch_frac"] == 0.0
    assert m["tid_mismatch_frac"] == 0.0
    assert m["t_rel_err_max"] <= cs.TRAV_TOLS["t_rel_err_max"]


@pytest.mark.parametrize("n_rays", [256, 4096], ids=["drain", "regen"])
def test_traversal_matches_brute_force(small_dragon, n_rays, monkeypatch):
    """Both traversal drivers against the brute force, at tiny size (the
    regeneration threshold lowered so 4096 rays take that driver)."""
    from rustracer_tpu.accel import traverse16 as T
    monkeypatch.setattr(T, "REGEN_MIN_B", 1024)
    ctx, cam = small_dragon[0], small_dragon[1]
    rays = cs.traversal_rays(cam, (32, 32), n_rays, seed=2)
    ref = cs.brute_force_hits(ctx.geom.tv_p, ctx.geom.t_idx, rays, chunk=256)
    got = jax.jit(T.bvh16_intersect_triangles)(ctx.geom, rays)
    anyhit = jax.jit(T.bvh16_intersect_p_triangles)(ctx.geom, rays)
    m = cs.compare_hits(ref, got, anyhit)
    m.pop("hit_frac")
    for k, v in m.items():
        assert v <= cs.TRAV_TOLS[k], (k, v)


def test_golden_compare():
    ref = np.load(os.path.join(REPO, "tests", "goldens",
                               "cornell-box.npz"))["img"]
    assert cs.golden_compare("cornell-box", ref) == (0.0, 0.0)
    mean_rel, p99_rel = cs.golden_compare("cornell-box", ref * 1.01)
    assert mean_rel == pytest.approx(0.01, rel=1e-3)
    assert p99_rel > mean_rel
    with pytest.raises(cs.PhaseFailed):
        cs.golden_compare("cornell-box", ref[:-1])


def test_device_activity_without_gpu_plane():
    act = cs.device_activity(
        lambda: jax.block_until_ready(jnp.ones(8) * 2))
    assert act["traced_wall_s"] >= 0.0
    assert act["idle_share"] is None and act["d2h_copies"] is None
