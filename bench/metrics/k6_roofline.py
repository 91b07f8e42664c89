"""k6_roofline (device trace and ``bench/costs``): K6's bound (``costs.
kernels.k6_bound_ms``, the per-head form on the f32 pipes) for each
Mamba-2 block of the traced unit's prefills (``costs/<family>.py``
``scan_layers`` a prefill), over the device time of the kernels named
``scan_*kernel`` in the trace, in %.  Nothing to read where no such
kernel ran."""
import torch

from bench.costs import kernels

PATTERN = r"(?<![A-Za-z_])scan_\w*kernel"


def read(run):
    if run.trace is None or run.rates is None:
        return None
    secs = run.trace.seconds(PATTERN)
    if secs <= 0 or run.costs.scan_layers(run.cfg) == 0:
        return None
    c, fam = run.cfg, run.costs
    bound_ms = sum(
        fam.scan_layers(c) * kernels.k6_bound_ms(
            B, P, fam.d_inner(c), c["ssm_state"],
            getattr(torch, fam.SCAN_DTYPE), run.rates,
            heads=fam.ssm_heads(c))[0]
        for P, B in ((b.prompt_len, b.rows) for b in run.traced))
    return 100.0 * bound_ms * 1e-3 / secs
