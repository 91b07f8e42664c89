"""capture_s (program counter): ``ServeEngine.timings['capture_s']``, the
seconds of the captured steps' warm-up runs and captures, all in
set-up."""


def read(run):
    return run.capture_s
