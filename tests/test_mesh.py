"""Sharding-equivalence tests: 1 device vs the 8-virtual-device mesh.

SURVEY §4 prescribes "1-device vs N-device bitwise/statistical parity";
the contract being reproduced is the reference's tile-parallel renderer
(rustracer-core/src/renderer.rs:56-76) whose output is independent of the
thread count. Here the sampler is stateless per (pixel, sample, dim), so a
sharded render must equal the single-device render up to float summation
order, and the psum'd training-step gradients must equal single-device
value_and_grad.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from helpers import (cornell_box, cornell_camera, frame_lanes,
                     shared_edge_miss_rate, single_device_train_loss)
from rustracer_tpu.integrators.path import PathIntegrator
from rustracer_tpu.parallel.mesh import (make_device_mesh,
                                         make_sharded_train_step,
                                         render_sharded)
from rustracer_tpu.render.film import Film
from rustracer_tpu.render.filters import Filter
from rustracer_tpu.render.renderer import (RenderConfig, RenderContext,
                                           Renderer)
from rustracer_tpu.render.sampler import SamplerConfig
from rustracer_tpu.scene.materials import MaterialSet, MatteMaterial
from rustracer_tpu.scene.textures import ConstantTexture

RES = (24, 24)
SPP = 2
DEPTH = 3


def _setup(imagemaps=False):
    """imagemaps=True swaps the red/green wall materials for IMAGEMAP
    mattes served through the shared mip atlas (atlas_meta in ctx), so the
    sharded render/grads exercise the atlas concat + per-slot EWA lookup
    under shard_map (round-4 blind spot: the sharded tests only ever ran
    constant textures)."""
    geom, lights = cornell_box()
    if imagemaps:
        from helpers import cornell_imagemap_materials
        ms, textures = cornell_imagemap_materials(seed_base=10)
    else:
        ms = MaterialSet()
        const = {}
        for i, a in enumerate([[0.73] * 3, [0.63, 0.065, 0.05],
                               [0.14, 0.45, 0.09], [0.0] * 3]):
            const[f"kd{i}"] = jnp.asarray(a, jnp.float32)
            ms.add(MatteMaterial(kd=ConstantTexture(f"kd{i}")))
        textures = {"const": const, "images": []}
    ctx = RenderContext(geom=geom, lights=lights, textures=textures)
    cam = cornell_camera(RES)
    film = Film(full_resolution=RES, filter=Filter("box", 0.5, 0.5))
    sampler = SamplerConfig(kind="02sequence", spp=SPP)
    integ = PathIntegrator(mat_set=ms, max_depth=DEPTH)
    return ctx, cam, film, sampler, integ


@pytest.mark.parametrize("imagemaps", [False, True],
                         ids=["const", "atlas-imagemaps"])
def test_render_sharded_matches_single_device(imagemaps):
    """Same image from the single-device Renderer and an 8-device
    (data=4, sample=2) shard_map render — with constant textures and with
    atlas-served imagemap materials (the atlas concat under shard_map)."""
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    ctx, cam, film, sampler, integ = _setup(imagemaps)

    single = Renderer(integ.li, cam, film, sampler,
                      RenderConfig(collect_stats=False)).render(ctx)

    mesh = make_device_mesh(data=4, sample=2)
    sharded = render_sharded(ctx, integ.li, cam, film, sampler, mesh)

    a, b = np.asarray(single), np.asarray(sharded)
    assert np.isfinite(b).all()
    # identical sample set; only float accumulation order differs
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-6)


@pytest.mark.slow
@pytest.mark.parametrize("imagemaps", [False, True],
                         ids=["const", "atlas-imagemaps"])
def test_sharded_grads_match_single_device(imagemaps):
    """make_sharded_train_step's psum'd gradients == single-device
    value_and_grad of the identical loss (the §5.8 gradient-reduction
    backend contract). The imagemap variant pushes TEXEL gradients through
    the atlas concat under shard_map (psum'd texture grads)."""
    assert len(jax.devices()) >= 8
    ctx, cam, film, sampler, integ = _setup(imagemaps)
    mesh = make_device_mesh(data=4, sample=2)
    n_sample = mesh.shape["sample"]
    px, py, valid = frame_lanes(film, mesh.shape["data"])

    # reference: single-device loss over the SAME lanes and sample ids
    single_loss, tex_f = single_device_train_loss(
        ctx, cam, film, sampler, integ, px, py, valid, n_sample)
    aux = {k: v for k, v in ctx.textures.items() if k not in tex_f}

    target = jnp.zeros(RES[::-1] + (3,), jnp.float32)
    lr = 0.25
    loss_1, grads_1 = jax.value_and_grad(single_loss)(tex_f, target)

    train = make_sharded_train_step(integ.li, cam, film, sampler, mesh, lr=lr)
    new_ctx, loss_n = train(ctx, target, px, py, valid, jnp.uint32(0))
    new_f = {k: v for k, v in new_ctx.textures.items() if k not in aux}
    grads_n = jax.tree.map(lambda p, q: (p - q) / lr, tex_f, new_f)

    np.testing.assert_allclose(float(loss_1), float(loss_n),
                               rtol=2e-5, atol=1e-8)
    for g1, gn in zip(jax.tree.leaves(grads_1), jax.tree.leaves(grads_n)):
        np.testing.assert_allclose(np.asarray(g1), np.asarray(gn),
                                   rtol=3e-4, atol=1e-7)
    # gradients are non-trivial (the test would pass vacuously otherwise)
    assert any(float(jnp.abs(g).max()) > 1e-6
               for g in jax.tree.leaves(grads_1))


def test_mesh_shapes_agree():
    """Different mesh factorizations of the same 8 devices give the same
    image (shardings are a pure execution detail)."""
    ctx, cam, film, sampler, integ = _setup()
    mesh_a = make_device_mesh(data=8, sample=1)
    img_a = render_sharded(ctx, integ.li, cam, film, sampler, mesh_a)
    mesh_b = make_device_mesh(data=4, sample=2)
    img_b = render_sharded(ctx, integ.li, cam, film, sampler, mesh_b)
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b),
                               rtol=2e-5, atol=2e-6)


def test_watertight_shared_edge_no_cracks():
    """Watertight property (mesh.rs:214-260): rays aimed exactly AT points
    on an edge shared by two triangles must hit at least one of them — the
    exact-sign edge functions (ops/triangle.py _edge_fn residual) may
    attribute the hit to either side but never to neither. Quantifies the
    edge-grazing miss rate the reference's f64 fallback guards against."""
    miss_rate, covered = shared_edge_miss_rate(n=4096)
    assert covered > 4096 // 2             # the filter keeps most rays
    assert miss_rate < 0.002, f"edge-crack miss rate {miss_rate:.4%}"
