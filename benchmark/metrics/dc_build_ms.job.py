"""dc_build_ms.job: mean host milliseconds per job of building the new
circuit's solver and plans: the port's spans `prepare.op.build` (the DC
chain's cached solver and plans, made anew for each new circuit) and
`prepare.pack.build` (K2's set-up's assemblers). Nothing where the port
opens no such span."""

KEYS = ("prepare.op.build", "prepare.pack.build")


def read(run):
    if any("prepare.pack" not in j["timings"] for j in run.jobs):
        return None
    return 1e3 * sum(j["timings"].get(k, 0.0) for j in run.jobs
                     for k in KEYS) / len(run.jobs)
