"""newton_pass_ms.sweep: the transient's host seconds (`sol.timings
["transient"]`) over its passes (`sol.host_syncs`, one Newton iteration
of every lane each), summed over the sweeps, in ms."""


def read(run):
    return (1e3 * sum(j["timings"]["transient"] for j in run.jobs)
            / sum(j["host_syncs"] for j in run.jobs))
