"""rustracer_tpu — a differentiable, physically-based wavefront renderer.

A from-scratch JAX/XLA re-design of the capability surface of
abusch/rustracer (a Rust port of PBRT-v3; see SURVEY.md). The compute path
is wavefront (megakernel-free): SoA ray batches flow through batched, jitted
stages for ray generation, BVH traversal, intersection, shading, and light
sampling; the whole estimator is differentiable, and tiles/samples shard
over a mesh of GPUs.
"""

__version__ = "0.1.0"
