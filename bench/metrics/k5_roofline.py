"""k5_roofline (device trace and ``bench/costs``): K5's bound (``costs.
kernels.k5_bound_ms``, bf16 on the tensor cores) for each attention call
of the traced unit's prefills (``costs/<family>.py`` ``attention_layers``
a prefill), over the device time of the kernels named ``flash_*kernel``
in the trace, in %.  Nothing to read where no such kernel ran."""
import torch

from bench.costs import kernels

PATTERN = r"(?<![A-Za-z_])flash_\w*kernel"


def read(run):
    if run.trace is None or run.rates is None:
        return None
    secs = run.trace.seconds(PATTERN)
    if secs <= 0:
        return None
    c = run.cfg
    bound_ms = sum(
        run.costs.attention_layers(c) * kernels.k5_bound_ms(
            B, c["n_heads"], c["n_kv_heads"], P, c["head_dim"], 0,
            getattr(torch, c["dtype"]), run.rates)[0]
        for P, B in ((b.prompt_len, b.rows) for b in run.traced))
    return 100.0 * bound_ms * 1e-3 / secs
