"""Cornell fwd+bwd sweep: remat x compaction combos.

The integrator has a custom-vjp permutation compact
(path.perm_take/perm_put) whose transpose is a masked gather, and the
bench step can wrap each sample in jax.checkpoint; this times all four
combos on the GPU (any other backend is refused) to pick the bench combo.
Usage: python tools/exp_fwdbwd.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from bench import build_cornell, bench_cornell_fwdbwd
from rustracer_tpu.utils.device import (card_label, configure_compile_cache,
                                        require_gpu)


def main():
    configure_compile_cache()
    require_gpu("tools/exp_fwdbwd.py")
    print(f"card: {card_label()}", flush=True)
    ctx, cam, film, sampler, integ = build_cornell()
    for remat in (True, False):
        for compact in (False, True):
            try:
                r = bench_cornell_fwdbwd(ctx, cam, film, sampler, integ,
                                         n_runs=3, remat=remat,
                                         compact=compact)
                print(f"remat={remat} compact={compact}: "
                      f"{r/1e6:6.3f} Mray/s", flush=True)
            except Exception as e:
                print(f"remat={remat} compact={compact}: FAILED {e!r}",
                      flush=True)


if __name__ == "__main__":
    main()
