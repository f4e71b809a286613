"""Each frozen copy in ``bench/`` held to its source in the port, on the
cases where the two should agree."""
import random

import pytest

from yardstick import devtrace, flights, sqlforms, ssbgen


@pytest.fixture(scope="module")
def canon():
    from repro_torch.core.sql_canon import SQLCanonicalizer

    return SQLCanonicalizer(ssbgen.port_schema())


@pytest.mark.parametrize("flight", sorted(flights.FLIGHTS))
def test_every_form_is_one_intent_as_the_ports_variants(canon, flight):
    """The forms canonicalize to one signature, the signature of the port's
    own 21 variants of the canonical form.  Forms of the ``eq_as_in``
    rewrite are left out: the port's canonicalizer keeps ``x IN ('v')``
    apart from ``x = 'v'`` (the same answer under another key), and the
    port's generator drops such a form where the signatures differ; the
    benchmark keeps it, and the reference checks its answers."""
    from repro_torch.workloads.variants import make_variants

    rng = random.Random(flight)
    for it in (flights.draw(rng, flight), flights.with_price_floor(flights.draw(rng, flight), rng)):
        forms = [sqlforms.render(it, f) for f in range(sqlforms.N_FORMS)]
        keys = {canon.canonicalize(t).key() for f, t in enumerate(forms)
                if sqlforms.form_of(f)[0] != "eq_as_in"}
        ported = {canon.canonicalize(t).key()
                  for t in make_variants(forms[0], ssbgen.port_schema(), n=21, seed=1)}
        assert len(keys) == 1 and keys == ported
        assert len(set(forms)) >= 12


def test_hierarchies_are_the_drill_sessions_paths():
    from repro_torch.workloads import hierarchical

    ported = {tuple(path) for _, _, path, _ in hierarchical._HIERARCHIES}
    ours = {tuple(lv.split(".")[1] for lv in path) for path in flights.HIERARCHIES.values()}
    assert ported <= ours
    assert ours - ported == {("c_city", "c_nation", "c_region")} or ours == ported | {
        ("d_yearmonth", "d_quarter", "d_year")}


@pytest.mark.parametrize("shape", [("B", 6_000_000, 2, 3, 2, 6, 35), ("B", 100, 1, 0, 1, 1, 1)])
def test_kernel_b_bytes_as_chip_smoke_counts_them(shape):
    _, n, m, p, k, s, g = shape
    bounds = s * p * k * 2  # the (S, P, K, 2) bounds tensor's elements
    assert devtrace.seg_agg_bytes(shape) == (n * (m + 1 + p) + s * g * m + bounds) * 4


def test_kernel_a_bytes():
    assert devtrace.seg_agg_bytes(("A", 10, 2, 3)) == (10 * 4 + 3 * 2) * 4
