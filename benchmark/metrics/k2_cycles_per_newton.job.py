"""k2_cycles_per_newton.job: K2's own clock64 cycles (`sol.phase_cycles`,
summed over phases and jobs) per Newton iteration (`sol.stats.nnewton`).
Nothing where the jobs ran K2's plain twin (no cycles)."""


def read(run):
    if any(j["cycles"] is None for j in run.jobs):
        return None
    return (sum(j["cycles"] for j in run.jobs)
            / sum(j["nnewton"] for j in run.jobs))
