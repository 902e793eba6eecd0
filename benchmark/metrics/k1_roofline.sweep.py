"""k1_roofline.sweep: the least time of one K1 launch of the sweep's
Newton pass, [lanes, n, n + 1] (`core/roofline.py`), over K1's device time
per launch in the trace (`gj_*_kernel`), in %."""
from benchmark.core import roofline, trace


def read(run):
    prof = run.profile
    times = trace.kernel_times(prof, "gj_warp_kernel", "gj_block_kernel",
                               "gj_grid_kernel") if prof else []
    if not times:
        return None
    n, _ = roofline.circuit_counts(run.cfg)
    t, _ = roofline.batched_solve_bound(run.traffic["lanes"], n, 1)
    return 100.0 * t / (sum(times) / len(times))
