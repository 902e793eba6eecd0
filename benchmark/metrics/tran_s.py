"""tran_s: the host wall of K2's transient (its launch and the sync that
ends it; `entries/vmem_tran.py`) summed over all finished jobs, over their
count."""


def read(run):
    return sum(j["tran_s"] for j in run.jobs) / len(run.jobs)
