"""prefill_mfu (program counter and ``bench/costs``): the FLOPs of the
window's prefills over the engine's prefill seconds
(``timings['prefill_s']``) and the card's dense bf16 peak, in %: the
captured prefill's share of the peak."""


def read(run):
    secs = run.engine_delta("prefill_s")
    if run.rates is None or secs <= 0:
        return None
    flops = sum(run.costs.prefill_flops(run.cfg, b.rows, b.prompt_len)
                for b in run.batches)
    return 100.0 * flops / secs / run.rates[2]
