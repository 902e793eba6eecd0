"""va_pack_ms.job: mean host milliseconds per job of K2's library for the
circuit's Verilog-A models: the port's span `prepare.pack.va` of
`vmem_tran` (the header of the emitted device functions, its hash and the
library's lookup; its build and load fall in the warm-up, the first job of
a process). Nothing where the port opens no such span."""


def read(run):
    if any("prepare.pack.va" not in j["timings"] for j in run.jobs):
        return None
    return 1e3 * sum(j["timings"]["prepare.pack.va"]
                     for j in run.jobs) / len(run.jobs)
