"""The port's Byrd & Friedman integrals (`sim5_tpu_torch.special`,
`integral_*`) against the C-reference goldens (tests/golden/special.txt)
and, for the families without a golden, against `sim5_tpu.special` on the
same numpy-seeded inputs, all in f64.

Tolerances:
* goldens (Rr0/1/2, Rrp, Rrp_inf, Tm0/2/p): relative 1e-9 (the port is
  within 1e-14 of C there);
* against the JAX package, by family, from its conditioning:
  - the single-integral forms (C1, C2, Z1, Z2, Rm1, Rm2, R1, R2, the
    `_cc` and `_bh` forms from one end, the `_dn` forms): relative
    1e-12 (a chain of Carlson and Jacobi evaluations, each within a few
    roundings);
  - the `_cc` forms between two ends X1 < X2 (R_r1_cc, R_r2_cc,
    R_rp_cc2): relative 1e-11, since each is a difference of two
    integrals from a common base (u2 - u1, R1(u2) - R1(u1)) that cancels
    as X1 -> X2; with X2 - X1 >= 0.1 here the cancellation costs at most
    about a decimal digit (measured: 5e-13).
"""

import jax
import numpy as np
import pytest
import torch

from sim5_tpu import special as jsp
from sim5_tpu_torch import special as tsp

torch.set_num_threads(2)

N = 64


def _t(*arrays):
    return [torch.tensor(np.asarray(v), dtype=torch.float64) for v in arrays]


@pytest.mark.parametrize("tag,fn,nargs", [
    ("Rr0", "integral_R_r0_re", 5), ("Rr1", "integral_R_r1_re", 5),
    ("Rr2", "integral_R_r2_re", 5), ("Rrp", "integral_R_rp_re", 6),
    ("Rrp_inf", "integral_R_rp_re_inf", 5), ("Tm0", "integral_T_m0", 3),
    ("Tm2", "integral_T_m2", 3), ("Tmp", "integral_T_mp", 4)])
def test_golden(golden_special, tag, fn, nargs):
    d = golden_special[tag]
    got = getattr(tsp, fn)(*_t(*(d[:, i] for i in range(nargs)))).numpy()
    want = d[:, nargs]
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-9)


def _families(seed=11):
    """{name: (function name, args, two-ended)} of the families without a
    golden, at numpy-seeded arguments inside each one's domain."""
    rng = np.random.default_rng(seed)

    def u(lo, hi):
        return rng.uniform(lo, hi, N)

    m = u(0.05, 0.95)
    K = tsp.elliptic_k(torch.tensor(m)).numpy()
    uu = u(0.0, 1.0) * K
    a_n = u(-3.0, 0.9)                       # Pi characteristics
    b_n = u(-2.0, 2.0)
    a_r = np.where(rng.uniform(size=N) < 0.5, u(-0.9, 0.9), u(1.1, 3.0))
    # two real roots a > b and a complex pair cu +- i cv; X1 < X2 above a
    b = u(0.3, 2.0)
    a = b + u(0.3, 3.0)
    cu, cv = u(-2.0, 0.0), u(0.3, 2.0)
    X1 = a + 10.0 ** u(-2, 1)
    X2 = X1 + 10.0 ** u(-1, 2)
    p_cc = np.where(rng.uniform(size=N) < 0.5, u(-1.0, 0.0), b - u(0.1, 1.0))
    # four real roots r1 > r2 > Y > r3 > r4 (the bound band), p outside it
    r4 = u(-3.0, -0.1)
    r3 = u(0.0, 1.0)
    r2 = r3 + u(0.3, 2.0)
    r1 = r2 + u(0.3, 5.0)
    Y = r3 + u(0.05, 0.95) * (r2 - r3)
    p_bh = np.where(rng.uniform(size=N) < 0.5, r3 - u(0.1, 1.0),
                    r2 + u(0.1, 1.0))
    # the dn band c^2 <= X^2 <= b^2, p outside it
    c2 = u(0.01, 0.3)
    b2 = c2 + u(0.05, 0.6)
    Xd = np.sqrt(c2 + u(0.0, 1.0) * (b2 - c2))
    p_dn = np.where(rng.uniform(size=N) < 0.5, c2 * u(0.1, 0.9),
                    b2 + u(0.05, 2.0))
    return {
        "C1": ("integral_C1", (uu, m), False),
        "C2": ("integral_C2", (uu, m), False),
        "C2_cos": ("integral_C2_cos", (u(-1.0, 1.0), m), False),
        "Z1": ("integral_Z1", (a_n, b_n, uu, m), False),
        "Z2": ("integral_Z2", (a_n, b_n, uu, m), False),
        "Rm1": ("integral_Rm1", (a_r, uu, m), False),
        "Rm2": ("integral_Rm2", (a_r, uu, m), False),
        "R1": ("integral_R1", (a_r, uu, m), False),
        "R2": ("integral_R2", (a_r, uu, m), False),
        "R_r0_re_inf": ("integral_R_r0_re_inf", (r1, r2, r3, r4), False),
        "R_r0_cc": ("integral_R_r0_cc", (a, b, cu, cv, X1), False),
        "R_r0_cc_inf": ("integral_R_r0_cc_inf", (a, b, cu, cv), False),
        "R_r1_cc": ("integral_R_r1_cc", (a, b, cu, cv, X1, X2), True),
        "R_r2_cc": ("integral_R_r2_cc", (a, b, cu, cv, X1, X2), True),
        "R_rp_cc2": ("integral_R_rp_cc2", (a, b, cu, cv, p_cc, X1, X2), True),
        "R_rp_cc2_inf": ("integral_R_rp_cc2_inf", (a, b, cu, cv, p_cc, X1),
                         False),
        "R_r0_bh": ("integral_R_r0_bh", (r1, r2, r3, r4, Y), False),
        "R_r1_bh": ("integral_R_r1_bh", (r1, r2, r3, r4, Y), False),
        "R_r2_bh": ("integral_R_r2_bh", (r1, r2, r3, r4, Y), False),
        "R_rp_bh": ("integral_R_rp_bh", (r1, r2, r3, r4, p_bh, Y), False),
        "T_m0_dn": ("integral_T_m0_dn", (c2, b2, Xd), False),
        "T_m2_dn": ("integral_T_m2_dn", (c2, b2, Xd), False),
        "T_mp_dn": ("integral_T_mp_dn", (c2, b2, p_dn, Xd), False),
    }


FAMILIES = _families()


class TestAgainstJax:
    """Every family without a golden, against one jitted JAX program that
    evaluates them all (one compile for the class)."""

    @pytest.fixture(scope="class")
    def jax_values(self):
        def all_families(args):
            return {k: getattr(jsp, fn)(*args[k])
                    for k, (fn, _, _) in FAMILIES.items()}
        args = {k: tuple(v) for k, (_, v, _) in FAMILIES.items()}
        out = jax.jit(all_families)(args)
        return {k: np.asarray(v) for k, v in out.items()}

    @pytest.mark.parametrize("name", sorted(FAMILIES))
    def test_family(self, jax_values, name):
        fn, args, two_ended = FAMILIES[name]
        got = getattr(tsp, fn)(*_t(*args)).numpy()
        want = jax_values[name]
        assert np.isfinite(want).all() and np.isfinite(got).all()
        np.testing.assert_allclose(got, want,
                                   rtol=1e-11 if two_ended else 1e-12,
                                   atol=1e-15)
