"""k2_host_ms.job: mean host milliseconds per job of `vmem_tran`'s
integrator less its wait for K2 (the port's spans `integrate` less
`integrate.wait`, the read of K2's statistics that ends the launch): the
packing of K2's arguments, the launch and the solution. Where the twin
ran (no wait), the whole integrator. Nothing where the port opens no
such span."""


def read(run):
    if any("integrate#n" not in j["timings"] for j in run.jobs):
        return None
    return 1e3 * sum(j["timings"]["integrate"]
                     - j["timings"].get("integrate.wait", 0.0)
                     for j in run.jobs) / len(run.jobs)
