"""Faults planted under a served cell's timed path, to show that its check
catches them (``tests/test_bench_faults.py`` at a small size,
``calibrate.py --faults`` at the cell's own).  Each wraps the engine's
``prefill`` / ``decode``: ``fault(kind, fn) -> fn``.  A served cell on one
chip can have these three; the exchange between chips has no place in
it."""
from __future__ import annotations


def _tree_clone(t):
    if isinstance(t, dict):
        return {k: _tree_clone(v) for k, v in t.items()}
    return t.clone()


def _tree_copy(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _tree_copy(dst[k], src[k])
    else:
        dst.copy_(src)


def state_unchanged(kind, fn):
    """Each decode step hands back its caches as they were before it."""
    if kind != "decode":
        return fn

    def step(caches, batch):
        before = _tree_clone(caches)
        logits, caches = fn(caches, batch)
        _tree_copy(caches, before)
        del before
        return logits, caches
    return step


def half_batch(kind, fn):
    """The second half of the batch left out: its rows get the mean of
    the first half's logits."""
    def step(*args):
        logits, caches = fn(*args)
        h = logits.shape[0] // 2
        logits[h:] = logits[:h].mean(dim=0)
        return logits, caches
    return step


def token_altered(kind, fn):
    """At every fifth decode step, from the third on, each row's token is
    not the one its logits put first but the next id."""
    if kind != "decode":
        return fn
    calls = {"n": 0}

    def step(caches, batch):
        logits, caches = fn(caches, batch)
        calls["n"] += 1
        if calls["n"] % 5 == 3:
            best = logits.argmax(dim=-1, keepdim=True)
            logits.scatter_(-1, (best + 1) % logits.shape[-1],
                            logits.gather(-1, best) + 1.0)
        return logits, caches
    return step


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  token_altered)}
