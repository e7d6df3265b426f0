"""How does XLA's device-memory row-gather rate depend on index coherence?

The wide-BVH traversal pays ~one 512 B row gather per lane-step
(accel/traverse16.py, `table[idx]`). If adjacent lanes ask for the same or
nearby rows (Morton-sorted camera wavefronts), the caches may serve them —
this measures that effect to size the win of wavefront sorting before
building it. Refuses to run on any backend but a GPU; every rate is printed
with the card's name and power limit.

Patterns, all (B,) int32 into an (R, W) f32 table:
  random    — uniform iid rows (the round-3 measured baseline)
  sorted    — the same multiset, sorted ascending (perfect coherence)
  block16   — random base rows, runs of 16 identical (duplicate-heavy,
              like 16 lanes of one wavefront touching one node)
  window    — sorted base + small jitter (Morton-like: nearby, not equal)
  seq       — pure sequential rows (upper bound; contiguity, not gather)

Usage: python tools/bench_gather_coherence.py [log2_rows] [log2_batch] [width]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def timed(f, *args, reps=5):
    """Best of `reps` calls, each ended by block_until_ready."""
    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    from rustracer_tpu.utils.device import (card_label,
                                            configure_compile_cache,
                                            require_gpu)
    configure_compile_cache()
    require_gpu("tools/bench_gather_coherence.py")
    card = card_label()
    lr = int(sys.argv[1]) if len(sys.argv) > 1 else 17
    lb = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    W = int(sys.argv[3]) if len(sys.argv) > 3 else 128
    R, B = 1 << lr, 1 << lb
    rs = np.random.RandomState(0)
    table = jnp.asarray(rs.rand(R, W), jnp.float32)

    rand = rs.randint(0, R, B).astype(np.int32)
    patterns = {
        "random ": rand,
        "sorted ": np.sort(rand),
        "block16": np.repeat(rs.randint(0, R, B // 16), 16).astype(np.int32),
        "window ": np.clip(np.sort(rand)
                           + rs.randint(-32, 32, B), 0, R - 1).astype(np.int32),
        "seq    ": (np.arange(B) % R).astype(np.int32),
    }
    gather = jax.jit(lambda t, i: t[i])
    # sum-reduced variant: no (B, W) device-memory write, isolates the read
    gsum = jax.jit(lambda t, i: t[i].sum(0))
    print(f"table {R}x{W} f32 ({R*W*4/2**20:.0f} MB), B={B}, card {card}",
          flush=True)
    for name, idx in patterns.items():
        i = jnp.asarray(idx)
        dt = timed(gather, table, i)
        dt2 = timed(gsum, table, i)
        print(f"{name}: full {B/dt/1e6:7.1f} M rows/s   "
              f"read-only {B/dt2/1e6:7.1f} M rows/s", flush=True)


if __name__ == "__main__":
    main()
