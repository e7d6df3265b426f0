"""CLI driver.

Reference: rustracer-cli/src/{main,argparse}.rs —
`rustracer <scene.pbrt> [-t N] [-o out] [-v]`. The `-t` thread count maps to
the lane-batch size knob (log2 of the wavefront width). The render runs on
JAX's default backend, the GPU where there is one; `--cpu` asks for the CPU,
and a run that lands on the CPU without it says so.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="rustracer-tpu",
        description="Differentiable wavefront path tracer (PBRT scenes)")
    p.add_argument("scene", help="PBRT scene file")
    p.add_argument("-o", "--output", default=None,
                   help="override output image filename")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="lane-batch log2 override (reference: thread count)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--cpu", action="store_true", help="force CPU jax backend")
    p.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    p.add_argument("--quick", action="store_true",
                   help="quick render: spp/4 (PbrtOptions.quick_render, "
                        "reference lib.rs:97-101)")
    p.add_argument("--progress", action="store_true", default=True)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="film checkpoint file: resume if present, snapshot "
                        "periodically (new capability; reference has none, "
                        "SURVEY §5.4)")
    p.add_argument("--checkpoint-every", type=int, default=8, metavar="SPP",
                   help="samples/pixel between checkpoints (default 8)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax profiler (xprof) trace of the render "
                        "to DIR (SURVEY §5.1 — the reference has no "
                        "profiler; PBRT's ProfilePhase was not ported)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from .device import configure_compile_cache, device_summary
    configure_compile_cache()
    dev = device_summary()
    print(f"device: {dev['platform']} ({dev['kind']}) x{dev['count']}")
    if dev["platform"] == "cpu" and not args.cpu:
        print("note: JAX found no accelerator; rendering on the CPU",
              file=sys.stderr)

    from ..utils.stats import init_stats, print_stats, print_phases
    from ..scene.api import parse_scene
    init_stats()

    t0 = time.time()
    api = parse_scene(args.scene, options={"quick_render": args.quick})
    bundle = api.scene
    if bundle is None:
        print("scene did not call WorldEnd; nothing to render", file=sys.stderr)
        return 1
    t_parse = time.time() - t0
    print(f"scene built in {t_parse:.2f}s")

    if args.spp:
        import dataclasses
        bundle.sampler = dataclasses.replace(bundle.sampler, spp=args.spp)

    max_lanes = 1 << 16
    if args.threads:
        max_lanes = 1 << max(10, min(22, args.threads))

    t1 = time.time()
    if args.profile:
        jax.profiler.start_trace(args.profile)
    img = bundle.render(progress=args.progress, max_lanes=max_lanes,
                        checkpoint=args.checkpoint,
                        checkpoint_every=args.checkpoint_every)
    import numpy as np
    img = np.asarray(img)
    if args.profile:
        jax.profiler.stop_trace()
        print(f"wrote profiler trace to {args.profile}")
    t_render = time.time() - t1
    print(f"render time: {t_render:.2f}s")

    out = args.output or bundle.filename
    from ..render.imageio import write_image
    write_image(out, img)
    print(f"wrote {out}")
    print_phases()
    print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
