"""The plain float32 references against the port's plain route
(``ModelFlags(use_kernel=False)``) on the CPU at tiny widths: prefill
logits, then decode logits through the port's cache, held against the
reference's full forward over the same tokens; and the check's control
(the reference in float8) fails a limit the port's bf16 serving meets."""
import pytest
import torch

from _bench_small import SMALL_LIMIT, arch, context, sizes

from bench import weights
from bench.drivers import serve
from bench.reference import common, dense, hybrid
from repro_torch.models.model import ModelFlags, build_model

def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


FAMILIES = [("granite-3-2b", dense), ("zamba2-1.2b", hybrid)]


@pytest.mark.parametrize("name,ref", FAMILIES)
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_reference_matches_port_prefill_and_decode(name, ref, seed):
    common.strict_f32()
    a = arch(name)
    model = build_model(a, ModelFlags(use_kernel=False))
    params = weights.draw(model.template(), seed, "cpu")
    p32 = _to_f32(params)
    R, S, n = 3, 37, 5
    toks = torch.randint(0, a.vocab, (R, S + n),
                         generator=torch.Generator().manual_seed(seed))
    logits, caches = model.prefill(p32, {"tokens": toks[:, :S]}, S + n + 2)
    port = [logits]
    for j in range(n - 1):
        logits, caches = model.decode_step(
            p32, caches, {"token": toks[:, S + j],
                          "positions": torch.full((R,), S + j)})
        port.append(logits)
    port = torch.stack(port, dim=1)
    want = ref.logits(sizes(a), params, toks[:, :S + n - 1], S - 1)
    assert want.shape == port.shape == (R, n, a.vocab)
    assert float((port - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_fp8_rounds_every_weight_product():
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(1))
    w = torch.randn(64, 8, generator=torch.Generator().manual_seed(2))
    exact = common.mm(x, w, "f32")
    low = common.mm(x, w, "fp8")
    rel = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.2
    with pytest.raises(ValueError):
        common.mm(x, w, "int3")


@pytest.mark.parametrize("name", ["granite-3-2b", "zamba2-1.2b"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_control_fails_where_the_program_passes(name, seed):
    """At a size a test run holds: the port's bf16 serving on the CPU stays
    under the limit; the float8 reference put in its place comes out not
    correct through the harness."""
    run = serve.run(context(name, seed, SMALL_LIMIT, control=True,
                            n_layers=4, d_model=128, d_ff=256))
    assert not run.correct, run.checks
    assert run.checks["gap_max"]["value"] > SMALL_LIMIT, run.checks
    assert run.checks["served_gap_max"]["value"] <= SMALL_LIMIT, run.checks
