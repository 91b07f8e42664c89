"""A whole run of the serve driver on the CPU, the look for a card left
out, with the timed path broken underneath the harness: the check must
come out not correct for each fault a served cell can have (the exchange
between chips has no place on one chip).  The same run unbroken passes."""
import pytest

from _bench_small import SMALL_LIMIT, context

from bench.drivers import serve
from bench.faults import half_batch, state_unchanged, token_altered

LIMIT = SMALL_LIMIT


@pytest.mark.parametrize("name", ["granite-3-2b", "zamba2-1.2b"])
def test_sound_run_is_correct(name):
    run = serve.run(context(name, 21, LIMIT))
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   token_altered])
@pytest.mark.parametrize("name", ["granite-3-2b", "zamba2-1.2b"])
def test_fault_is_not_correct(name, fault):
    run = serve.run(context(name, 21, LIMIT, fault=fault))
    assert not run.correct, (fault.__name__, run.checks)
    assert run.checks["gap_max"]["value"] > LIMIT


def test_malformed_answers_and_unread_numbers_fail():
    """An answer of the wrong length or with an id outside the vocabulary
    is a failed request; a reading that is not a number fails its
    limit."""
    from bench import check
    assert check.malformed([[1, 2, 3], [1, 2], [1, 2, 99]], 3, 97) == 2
    ok, checks = check.limit_checks({"gap_max": float("nan")},
                                    {"gap_max": 1.0})
    assert not ok and checks["gap_max"]["limit"] == 1.0
