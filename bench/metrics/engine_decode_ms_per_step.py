"""engine_decode_ms_per_step (program counter): ``ServeEngine.timings``
decode seconds over decode steps, over every step of the window's
batches: a captured decode step, its sampling and the read of its
tokens."""


def read(run):
    n = run.engine_delta("decode_steps")
    return run.engine_delta("decode_s") / n * 1e3 if n else None
