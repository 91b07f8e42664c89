"""warmup_s (program counter): ``ServeEngine.timings['warmup_s']`` after
the window: the host's seconds in the captured steps' eager warm-up runs,
all in set-up, a part of ``capture_s`` (no sync: the warm-ups' device
tail is waited out inside the capture).  Nothing to read where the
engine has no such counter."""


def read(run):
    return run.engine_after.get("warmup_s")
