"""decode_launch_ms_per_step (program counter): ``ServeEngine.timings``
``decode_launch_s`` over decode steps, over the window: the host's
seconds in the captured decode step's ``graph.step`` (its inputs copied
into the static buffers and the graph replay enqueued;
``CapturedStep.run_s``).  Nothing to read where the engine has no such
counter.

Not listed in ``BENCHMARK.json``: the per-layer metrics are read from
the ``--trace 1`` run, whose window follows ``trace.warm()``, and once
the profiler has run a replay costs the host about a millisecond more,
so there the value is mostly the profiler's overhead (1.1-1.8 ms a
step, against 0.05-0.19 ms in a ``--trace 0`` window, on an H100)."""


def read(run):
    if "decode_launch_s" not in run.engine_after:
        return None
    n = run.engine_delta("decode_steps")
    return run.engine_delta("decode_launch_s") / n * 1e3 if n else None
