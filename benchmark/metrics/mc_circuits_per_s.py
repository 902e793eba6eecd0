"""mc_circuits_per_s: converged lanes of every finished sweep over the
host wall of those sweeps (operating point included)."""


def read(run):
    return sum(j["converged"] for j in run.jobs) / run.window_s
