"""dc_s.job: mean host seconds of the DC operating point per job, the
port's span `prepare.op` of `vmem_tran` (`cadnip_tpu_torch/obs.py`): the
part of `op_s.job` before K2's set-up. Nothing where the port opens no
such span."""


def read(run):
    if any("prepare.op" not in j["timings"] for j in run.jobs):
        return None
    return sum(j["timings"]["prepare.op"] for j in run.jobs) / len(run.jobs)
