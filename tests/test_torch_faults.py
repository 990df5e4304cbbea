"""The port's fault-injection engine (blaze_tpu_torch/faults.py) against
the JAX package's (blaze_tpu/faults.py): for the same rule string and
seed, the same occurrences of each site fire; a site of the reference
the port has no code point for raises ValueError naming ROADMAP item 16;
and the port's five sites act: `task-start` is retried, `shuffle-read`
re-runs the producer map task through lineage recovery, `quota-breach`
climbs a query's ladder, `admit` sheds and `cancel-race` is evaluated
by QueryService.cancel."""

import pytest

from blaze_tpu import faults as jfaults
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import faults
from blaze_tpu_torch.bridge import device_stats

RULES = [("task-start=0.05,shuffle-read=0.03", 7),
         ("task-start=0.05,shuffle-read=0.03", 0),
         ("admit@2+5,cancel-race=0.5*2", 3),
         ("quota-breach=0.3:raise,task-start@1+4+9", 11),
         ("shuffle-read=0.2*3,admit=0.1", 123)]
OCCURRENCES = 200


@pytest.fixture(autouse=True)
def clean():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()
    for opt in (tconf.FAULTS_ENABLE, tconf.FAULTS_RULES, tconf.FAULTS_SEED,
                tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.TASK_RETRY_BACKOFF_MS):
        tconf.conf.unset(opt.key)


def _fired(mod, site):
    """Occurrence indices (1-based) of `site` that fire, by `fires`."""
    return [k for k in range(1, OCCURRENCES + 1) if mod.fires(site)]


@pytest.mark.parametrize("rules,seed", RULES)
def test_same_rules_and_seed_fire_on_the_same_calls(rules, seed):
    faults.configure(rules, seed)
    jfaults.configure(rules, seed)
    for site in faults.SITES:
        assert _fired(faults, site) == _fired(jfaults, site), site
    assert faults.stats() == jfaults.stats()


@pytest.mark.parametrize("rules,seed", RULES[:2])
def test_maybe_fail_raises_where_the_jax_engine_does(rules, seed):
    faults.configure(rules, seed)
    jfaults.configure(rules, seed)
    for site in ("task-start", "shuffle-read"):
        got, want = [], []
        for k in range(OCCURRENCES):
            for mod, out, exc in ((faults, got, faults.InjectedFault),
                                  (jfaults, want, jfaults.InjectedFault)):
                try:
                    mod.maybe_fail(site, task=k)
                except exc as e:
                    out.append((k, str(e)))
        assert got == want and got


def test_parse_rules_equals_the_jax_grammar():
    spec = ("task-start=0.25, shuffle-read=0.5*3,admit@2+7,"
            "cancel-race=0.1:raise,quota-breach@1*1")
    assert faults.parse_rules(spec) == jfaults.parse_rules(spec)
    with pytest.raises(ValueError, match="bad fault rule"):
        faults.parse_rules("task-start")


@pytest.mark.parametrize("spec", ["quota-breach=0.3:corrupt",
                                  "task-start@1:corrupt",
                                  "cancel-race=0.1:flip"])
def test_an_action_the_port_lacks_is_refused(spec):
    """`corrupt` acts only at shuffle-write, a later site: refused with
    item 16, at parse time and at install, as the later sites are."""
    match = "item 16" if spec.endswith("corrupt") else "unknown fault action"
    with pytest.raises(ValueError, match=match):
        faults.parse_rules(spec)
    with pytest.raises(ValueError, match=match):
        faults.configure(spec)
    with pytest.raises(ValueError, match=match):
        faults.FaultInjector().install(spec.split("=")[0].split("@")[0],
                                       p=0.5, action=spec.rsplit(":", 1)[1])


@pytest.mark.parametrize("site", faults.LATER_SITES)
def test_a_site_the_port_lacks_names_item_16(site):
    assert site in jfaults.SITES
    with pytest.raises(ValueError, match="item 16"):
        faults.parse_rules(f"{site}=0.5")
    with pytest.raises(ValueError, match="item 16"):
        faults.configure(f"{site}@1")


def test_every_reference_site_is_ported_or_later():
    assert set(faults.SITES) | set(faults.LATER_SITES) == set(jfaults.SITES)
    assert not set(faults.SITES) & set(faults.LATER_SITES)
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.parse_rules("task-strat=0.5")


def test_activate_from_conf_and_scoped_restore():
    tconf.conf.set(tconf.FAULTS_ENABLE.key, "true")
    tconf.conf.set(tconf.FAULTS_RULES.key, "admit@1")
    tconf.conf.set(tconf.FAULTS_SEED.key, 5)
    assert faults.fires("admit")  # the lazy conf probe built the injector
    assert not faults.fires("admit")
    before = faults._current()
    with faults.scoped(("task-start", dict(at=(1,)))) as inj:
        assert faults._current() is inj
        with pytest.raises(faults.InjectedFault):
            faults.maybe_fail("task-start")
    assert faults._current() is before
    tconf.conf.set(tconf.FAULTS_ENABLE.key, "false")
    assert faults.activate_from_conf() is None
    assert not faults.fires("admit")


def test_injected_fault_is_retryable_and_counted():
    from blaze_tpu_torch.bridge.tasks import run_tasks
    assert faults.classify_exception(faults.InjectedFault("x")) == \
        jfaults.classify_exception(jfaults.InjectedFault("x")) == "retryable"
    tconf.conf.set(tconf.TASK_RETRY_BACKOFF_MS.key, 0)
    before = device_stats.snapshot()
    with faults.scoped(("task-start", dict(at=(1, 3)))):
        assert run_tasks(lambda i: i * 2, 3, "chaos") == [0, 2, 4]
    delta = device_stats.delta(before)
    assert delta["faults_injected"] == 2
    assert delta["task_retries"] == 2


def test_shuffle_read_fault_recovers_through_lineage(tmp_path):
    """A fetch the site fails is a FetchFailedError naming its producer:
    the scheduler re-runs that one map task and the rows are those of a
    run without faults."""
    from blaze_tpu_torch.itest.runner import frame
    from blaze_tpu_torch.plan.stages import DagScheduler
    from test_torch_serving_queries import two_stage_plan
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    plan = two_stage_plan(tmp_path)
    want = frame(DagScheduler().run_collect(plan))
    before = device_stats.snapshot()
    sched = DagScheduler()
    with faults.scoped(("shuffle-read", dict(at=(1,)))):
        got = frame(sched.run_collect(plan))
    assert got.equals(want)
    assert max(sched.task_runs.values()) == 2
    delta = device_stats.delta(before)
    assert delta["stage_recoveries"] == 1 and delta["faults_injected"] == 1
    assert not any(sched.leak_report().values())


def test_quota_breach_site_forces_a_rung():
    from blaze_tpu_torch.bridge.context import query_scope
    from blaze_tpu_torch.memory import MemManager
    from blaze_tpu_torch.memory.manager import MemConsumer
    from blaze_tpu_torch.serving import QueryContext

    class Held(MemConsumer):
        def spill(self):
            freed = self.mem_used
            self._mem_used = 0
            return freed

    mm = MemManager.init(4 << 30)
    ctx = QueryContext()  # no quota: only the injected breach climbs
    with query_scope(ctx), faults.scoped(("quota-breach", dict(at=(2,)))):
        c = Held("held")
        c.set_spillable(mm)
        c.update_mem_used(1000)
        assert ctx.degrade_level == 0
        c.update_mem_used(2000)
        assert ctx.degrade_level == 1 and ctx.force_agg_passthrough
        assert c.mem_used == 0  # shed down to 0.8 of its own bytes
        c.unregister()


def test_cancel_race_site_is_evaluated_by_cancel():
    from blaze_tpu_torch.serving import QueryService

    def ex(plan, ctx, handle):
        ctx.wait_cancelled(30)
        ctx.check()
        return "unreachable"

    with QueryService(executor=ex) as svc:
        h = svc.submit({"kind": "noop"})
        with faults.scoped(("cancel-race", dict(at=(1,)))) as inj:
            assert svc.cancel(h.query_id) is True
            assert inj.stats()["cancel-race"] == {"evals": 1, "fires": 1}
        assert h.exception(30) is not None
