"""decode_read_ms_per_step (program counter): ``ServeEngine.timings``
``decode_read_s`` over decode steps, over the window: the seconds the
decode loop spent blocked in its ``serve.read`` spans, reading the active
mask and the tokens, which on the card is mostly the wait for the step's
device work.  Nothing to read where the engine has no such counter."""


def read(run):
    if "decode_read_s" not in run.engine_after:
        return None
    n = run.engine_delta("decode_steps")
    return run.engine_delta("decode_read_s") / n * 1e3 if n else None
