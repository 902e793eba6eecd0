"""k2_setup_ms.job: mean host milliseconds per job of K2's set-up after
the operating point (initial charges, differential rows, breakpoints,
step-control scalars): the port's span `prepare.pack` of `vmem_tran`.
Nothing where the port opens no such span."""


def read(run):
    if any("prepare.pack" not in j["timings"] for j in run.jobs):
        return None
    return 1e3 * sum(j["timings"]["prepare.pack"]
                     for j in run.jobs) / len(run.jobs)
