"""The port's own copy of the symbolic layer compiles every app program to
the same triggers, costs and FLOP counts as the JAX package."""

import dataclasses

import pytest

from repro.apps.ols import build_ols_program as jax_ols
from repro.core import IncrementalEngine as JaxEngine
from repro.core import compile_batched_trigger as jax_batched
from repro.core import compile_program as jax_compile
from repro.core import iterative as jax_it
from repro_torch.apps.ols import build_ols_program as torch_ols
from repro_torch.core import IncrementalEngine as TorchEngine
from repro_torch.core import compile_batched_trigger as torch_batched
from repro_torch.core import compile_program as torch_compile
from repro_torch.core import iterative as torch_it

# name -> builder taking (ols builder, iterative module) of one package
PROGRAMS = {
    "ols": lambda ols, it: ols(48, 12, 2),
    "powers_linear": lambda ols, it: it.matrix_powers(8, 24, "linear"),
    "powers_exp": lambda ols, it: it.matrix_powers(8, 24, "exp"),
    "powers_skip": lambda ols, it: it.matrix_powers(8, 24, "skip", s=2),
    "sums_linear": lambda ols, it: it.sums_of_powers(8, 24, "linear"),
    "sums_exp": lambda ols, it: it.sums_of_powers(8, 24, "exp"),
    "sums_skip": lambda ols, it: it.sums_of_powers(8, 24, "skip", s=2),
    "general_exp": lambda ols, it: it.general_form(8, 24, 3, "exp"),
    "general_linear": lambda ols, it: it.general_form(4, 24, 3, "linear"),
    "general_skip": lambda ols, it: it.general_form(8, 24, 3, "skip", s=2),
}

OPTIONS = {"default": {}, "sequential_sm": {"sequential_sm": True},
           "dense": {"force_rep": "dense"}}


def _signature(trig):
    return {
        "input": trig.input_name, "rank": trig.rank,
        "vars": (trig.u_var.name, trig.v_var.name),
        "assigns": [(a.name, repr(a.expr)) for a in trig.assigns],
        "updates": [dataclasses.astuple(up) for up in trig.updates],
        "reps": dict(trig.reps), "carriers": dict(trig.carriers),
        "cost": dataclasses.astuple(trig.cost), "repr": repr(trig),
    }


def _both(name):
    build = PROGRAMS[name]
    return build(jax_ols, jax_it), build(torch_ols, torch_it)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compiled_triggers_match(name):
    jprog, tprog = _both(name)
    jc, tc = jax_compile(jprog), torch_compile(tprog)
    assert [repr(s.expr) for s in jc.statements] == \
        [repr(s.expr) for s in tc.statements]
    assert sorted(jc.triggers) == sorted(tc.triggers)
    for inp in jc.triggers:
        assert _signature(jc.triggers[inp]) == _signature(tc.triggers[inp])
        for bucket in (4, 16):
            assert _signature(jax_batched(jc, inp, bucket)) == \
                _signature(torch_batched(tc, inp, bucket))


@pytest.mark.parametrize("option", sorted(OPTIONS))
@pytest.mark.parametrize("name", ["ols", "powers_exp", "general_exp"])
def test_trigger_and_reeval_flops_match(name, option):
    jprog, tprog = _both(name)
    kw = OPTIONS[option]
    je = JaxEngine(jprog, **kw)
    te = TorchEngine(tprog, device="cpu", **kw)
    for inp, trig in je.compiled.triggers.items():
        assert _signature(trig) == _signature(te.compiled.triggers[inp])
        assert te.trigger_flops(inp) == je.trigger_flops(inp)
    assert te.reeval_flops() == je.reeval_flops()
