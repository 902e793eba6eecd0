"""op_s.job: mean of `sol.timings["prepare"]` per job: the DC operating
point and the fused transient's set-up."""


def read(run):
    return sum(j["timings"]["prepare"] for j in run.jobs) / len(run.jobs)
