"""The Spark conformance corpus through the PyTorch port
(blaze_tpu_torch/itest/spark_corpus.py and spark_corpus_ext.py, copies
of the JAX package's 357 vectors in 65 suites), on the CPU.

  * every case is one parametrised test: it passes through the port
    (IR -> `create_plan` -> execute over a memory scan), or it is
    xfail(strict=True) naming the ROADMAP item it waits for
    (`later_item`), so a case that starts to pass fails here until its
    mark goes; since the decimal slice no case waits, the 27 that hold a
    decimal (`holds_decimal`) included;
  * the port's copy equals `blaze_tpu.itest.spark_corpus.SUITES`: the
    same suite names, case names, input tables, IR (expressions, and the
    plans built over the same scans), expected rows, tolerances, confs,
    ordering and expected errors, so the two copies cannot drift;
  * the include/exclude DSL selects as the JAX one does.

Tolerance: each case's own (`rtol`, 0 = exact; NaN equal to NaN)."""

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import spark_corpus as TC

_ALL = [(s, c.name) for s, cases in sorted(TC.SUITES.items())
        for c in cases]


@pytest.fixture(autouse=True)
def cpu_device():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _case(suite, name):
    return next(c for c in TC.SUITES[suite] if c.name == name)


def _params():
    for suite, name in _ALL:
        item = TC.later_item(suite, _case(suite, name))
        marks = () if item is None else pytest.mark.xfail(
            strict=True, reason=item)
        yield pytest.param(suite, name, marks=marks,
                           id=f"{suite}::{name}")


@pytest.mark.parametrize("suite,case_name", list(_params()))
def test_corpus_case(suite, case_name):
    res = TC.run_case(suite, _case(suite, case_name))
    assert res.passed, f"{suite}::{case_name}: {res.detail}"


def _same_table(a, b) -> bool:
    """Same schema and the same values (NaN equal to NaN, -0.0 apart
    from 0.0: their reprs)."""
    return a.schema.equals(b.schema) and \
        repr(a.to_pylist()) == repr(b.to_pylist())


def test_the_corpus_is_the_jax_one():
    from blaze_tpu.itest import spark_corpus as JC
    assert sorted(TC.SUITES) == sorted(JC.SUITES)
    assert len(TC.SUITES) == 65 and len(_ALL) == 357
    for suite in JC.SUITES:
        t_cases, j_cases = TC.SUITES[suite], JC.SUITES[suite]
        assert [c.name for c in t_cases] == [c.name for c in j_cases]
        for t, j in zip(t_cases, j_cases):
            where = f"{suite}::{t.name}"
            assert _same_table(t.input, j.input), where
            assert (t.input2 is None) == (j.input2 is None), where
            if t.input2 is not None:
                assert _same_table(t.input2, j.input2), where
            assert repr(t.exprs) == repr(j.exprs), where
            assert repr(t.expected) == repr(j.expected), where
            assert (t.rtol, t.confs, t.unordered, t.raises) == \
                (j.rtol, j.confs, j.unordered, j.raises), where
            assert (t.plan is None) == (j.plan is None), where
            if t.plan is not None:
                scans = [JC._scan_ir("a", t.input)]
                if t.input2 is not None:
                    scans.append(JC._scan_ir("b", t.input2))
                assert repr(t.plan(*scans)) == repr(j.plan(*scans)), where


def test_the_later_cases_are_the_decimal_ones():
    """The 27 cases that waited for the decimal slice hold a decimal, and
    no case waits any longer."""
    assert all(TC.later_item(s, _case(s, n)) is None for s, n in _ALL)
    later = [(s, n) for s, n in _ALL if TC.holds_decimal(_case(s, n))]
    assert len(later) == 27
    assert {s for s, _ in later} == {
        "Decimal38Suite", "DecimalArithmeticSuite", "DecimalSuite",
        "AnsiArithmeticEdgeSuite", "TryArithmeticSuite",
        "TryArithmeticWidthSuite"}


def test_dsl_include_exclude():
    s = TC.CorpusSettings()
    st = s.enable_suite("MathSuite").include_by_prefix("round")
    st.exclude("round is HALF_UP away from zero", reason="demo")
    assert [r.case for r in TC.run_corpus(s)] == []
    with pytest.raises(KeyError):
        s.enable_suite("NoSuchSuite")
    assert len(TC.run_corpus(TC.default_settings())) == 357
