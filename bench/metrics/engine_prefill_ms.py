"""engine_prefill_ms (program counter): ``ServeEngine.timings`` prefill
seconds over prefill calls, over the window (every batch the window ran):
a captured prefill, its sampling and the read of its tokens."""


def read(run):
    n = run.engine_delta("prefills")
    return run.engine_delta("prefill_s") / n * 1e3 if n else None
