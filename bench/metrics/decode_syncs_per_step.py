"""decode_syncs_per_step (program counter): ``ServeEngine.timings``
``decode_syncs`` over decode steps, over the window: the blocking reads
of device values the decode loop makes a step.  Nothing to read where
the engine has no such counter."""


def read(run):
    if "decode_syncs" not in run.engine_after:
        return None
    n = run.engine_delta("decode_steps")
    return run.engine_delta("decode_syncs") / n if n else None
