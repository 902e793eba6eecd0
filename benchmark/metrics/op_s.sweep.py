"""op_s.sweep: mean of `sol.timings["op"]` per sweep: the operating point
of every lane on the host loop."""


def read(run):
    return sum(j["timings"]["op"] for j in run.jobs) / len(run.jobs)
