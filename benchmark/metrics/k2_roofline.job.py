"""k2_roofline.job: the least time of the traced job's K2 launch (its
inputs and save grid once over HBM, or one LU solve per Newton iteration
over the FP64 peak; `core/roofline.py`) over K2's device time per launch
in the trace (`vmem_kernel`), in %."""
from benchmark.core import roofline, trace


def read(run):
    prof = run.profile
    times = trace.kernel_times(prof, "vmem_kernel") if prof else []
    if not times:
        return None
    n, in_bytes = roofline.circuit_counts(run.cfg)
    job = prof["job"]
    t, _ = roofline.transient_bound(n, job["n_save"], in_bytes,
                                    job["nnewton"])
    return 100.0 * t / (sum(times) / len(times))
