"""mfu (host clock and ``bench/costs``): the FLOPs of the work finished in
the window (``ServeRun.work_in_window``: each prefill's and decode step's
tokens, as ``costs/<family>.py`` counts them) over the window's seconds
and the card's dense bf16 peak, in %."""


def read(run):
    if run.rates is None:
        return None
    return 100.0 * run.work_in_window()[1] / run.window_s / run.rates[2]
