"""Port vs reference: SMDP construction and exact policy evaluation.

The port's core/smdp.py and the evaluators are numpy copies of the
reference, so the built arrays must be bit-identical and the evaluations
agree to 1e-12 (relative).  Specs cross over through interop, which also
exercises the converter on every profile type used here.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import (
    GOOGLENET_P4_ENERGY,
    GOOGLENET_P4_LATENCY,
    ConstantProfile,
    ServiceModel,
    SMDPSpec,
    build_smdp,
    build_smdp_batched,
    evaluate_policy,
    greedy_policy,
    q_policy,
    static_policy,
)
from repro.core.profiles import tpu_service_model, workload_for_arch
from repro_torch import interop
from repro_torch import core as pt

DENSE_FIELDS = ("feasible", "y", "c_hat", "m_hat", "c_tilde", "m_tilde",
                "c_hold", "c_energy", "arrival_pmfs")
BATCH_FIELDS = ("feasible", "y", "c_hat", "eta", "c_tilde", "c_hold",
                "c_energy", "arrival_pmfs", "pmfs_banded", "tails", "scale")


def paper_spec(rho=0.7, w2=1.0, s_max=128, b_max=32, c_o=100.0, family="det"):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family=family)
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY,
        b_min=1, b_max=b_max, w1=1.0, w2=w2, s_max=s_max, c_o=c_o,
    )


def finite_spec(rho=0.7, b_max=16, B=48, c_drop=25.0, w2=1.0):
    svc = ServiceModel(latency=GOOGLENET_P4_LATENCY, family="det")
    lam = rho * b_max / float(svc.mean(b_max))
    return SMDPSpec(
        lam=lam, service=svc, energy=GOOGLENET_P4_ENERGY, b_min=1,
        b_max=b_max, w1=1.0, w2=w2, s_max=B, buffer=B, c_drop=c_drop,
    )


def tpu_spec():
    svc, energy = tpu_service_model(
        workload_for_arch(3e9, 32, 8, 128, context_len=2048), family="erlang"
    )
    lam = 0.6 * 16 / float(svc.mean(16))
    return SMDPSpec(lam=lam, service=svc, energy=energy, b_max=16, s_max=40)


SPECS = {
    "quickstart": lambda: paper_spec(w2=1.6),
    "rho0.5_s64": lambda: paper_spec(rho=0.5, s_max=64),
    "rho0.9_s70": lambda: paper_spec(rho=0.9, s_max=70),
    "erlang": lambda: paper_spec(s_max=48, family="erlang"),
    "expo": lambda: paper_spec(s_max=48, family="expo"),
    "hyperexpo": lambda: paper_spec(s_max=48, family="hyperexpo"),
    "ideal_expo_b8": lambda: SMDPSpec(
        lam=0.5 * 8 / 2.4252,
        service=ServiceModel(latency=ConstantProfile(2.4252), family="expo"),
        energy=GOOGLENET_P4_ENERGY, b_max=8, s_max=100,
    ),
    "finite_buffer": finite_spec,
    "finite_buffer_overload": lambda: finite_spec(rho=1.3, c_drop=50.0),
    "tpu_roofline_erlang": tpu_spec,
}


def _equal(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_build_smdp_bit_identical(name):
    ref_spec = SPECS[name]()
    port_spec = interop.spec_from_reference(ref_spec)
    assert isinstance(port_spec, pt.SMDPSpec)
    ref, got = build_smdp(ref_spec), pt.build_smdp(port_spec)
    for field in DENSE_FIELDS:
        assert _equal(getattr(ref, field), getattr(got, field)), field
    assert ref.eta == got.eta


def test_build_smdp_batched_bit_identical():
    """A mixed batch (tail-abstracted and finite-buffer specs)."""
    ref_specs = [paper_spec(rho=r, s_max=48, b_max=16, w2=w)
                 for r, w in ((0.3, 0.0), (0.7, 1.0), (0.9, 5.0))]
    ref_specs.append(finite_spec())
    ref = build_smdp_batched(ref_specs)
    got = pt.build_smdp_batched([interop.spec_from_reference(s) for s in ref_specs])
    for field in BATCH_FIELDS:
        assert _equal(getattr(ref, field), getattr(got, field)), field
    for i in range(len(ref_specs)):
        pol = greedy_policy(48, 1, 16)
        assert _equal(ref.policy_transitions(i, pol), got.policy_transitions(i, pol))


POLICIES = {
    "greedy": lambda s: greedy_policy(s.s_max, s.b_min, s.b_max),
    "static8": lambda s: static_policy(min(8, s.b_max), s.s_max),
    "static_bmax": lambda s: static_policy(s.b_max, s.s_max),
    "q4": lambda s: q_policy(4, s.s_max, s.b_max),
}


@pytest.mark.parametrize("name", ["quickstart", "rho0.9_s70", "expo", "finite_buffer"])
@pytest.mark.parametrize("pol", sorted(POLICIES))
def test_evaluate_policy_matches(name, pol):
    ref_spec = SPECS[name]()
    policy = POLICIES[pol](ref_spec)
    try:
        want = evaluate_policy(build_smdp(ref_spec), policy)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            pt.evaluate_policy(pt.build_smdp(interop.spec_from_reference(ref_spec)),
                               policy)
        return
    got = pt.evaluate_policy(pt.build_smdp(interop.spec_from_reference(ref_spec)), policy)
    for field in ("g", "delta", "w_bar", "p_bar", "mean_batch", "throughput"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-12, atol=1e-300, err_msg=field)
    np.testing.assert_allclose(got.mu, want.mu, rtol=1e-12, atol=1e-15)


def test_spec_from_reference_round_trips_every_field():
    ref_spec = dataclasses.replace(paper_spec(family="hyperexpo"), c_o=321.0)
    got = interop.spec_from_reference(ref_spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref_spec)
    assert type(got.service.latency) is pt.AffineProfile


def test_spec_from_reference_rejects_unknown_types():
    @dataclasses.dataclass(frozen=True)
    class Mystery:
        x: float = 1.0

    bad = dataclasses.replace(paper_spec(), energy=Mystery())
    with pytest.raises(TypeError, match="no port counterpart"):
        interop.spec_from_reference(bad)


def test_build_smdp_modulated_bit_identical():
    """The modulated builders came along as a plain copy: same arrays."""
    from repro.core.smdp import PhaseConfig, build_smdp_modulated_batched, modulated_spec
    from repro_torch.core import smdp as psmdp

    lam = paper_spec().lam
    rates, dwells = (0.4 * lam, 1.3 * lam), (60.0, 30.0)
    ref_ph = [PhaseConfig.mmpp2(*rates, *dwells)]
    ref_specs = [modulated_spec(paper_spec(s_max=40, b_max=16), ref_ph[0])]
    ref = build_smdp_modulated_batched(ref_specs, ref_ph)
    got_ph = [psmdp.PhaseConfig.mmpp2(*rates, *dwells)]
    got = psmdp.build_smdp_modulated_batched(
        [interop.spec_from_reference(s) for s in ref_specs], got_ph)
    for field in ("feasible", "y", "c_hat", "eta", "c_tilde", "c_hold", "c_energy",
                  "scale", "pmfs_banded", "tails", "wait_m", "lam_eff"):
        assert _equal(getattr(ref, field), getattr(got, field)), field
