"""Failure classification for task retry and lineage recovery, and the
deterministic fault-injection engine (the port's copy of
blaze_tpu/faults.py).

  * `FetchFailedError`: a shuffle block could not be read back intact.  It
    names the producer stage and map task that wrote the block, so the
    stage scheduler (plan/stages.py) re-runs only that map task.
  * `classify_exception`: 'retryable' (transient IO, a corrupt frame, an
    injected fault, a leaked stage-loop fallback), 'fetch-failed' (lineage
    recovery, never a retry in place) or 'fatal' (plan, serde and logic
    errors, a cancelled query: fail fast).
  * The injection engine: a process-wide registry of seeded rules over
    named sites, so chaos runs script failures deterministically and
    hold recovery to the same rows.

Sites of the port (the code points that call in here):
    task-start     bridge/tasks.py, before each task attempt
    shuffle-read   shuffle/reader.py, per file-segment block fetch (the
                   block then fails as a FetchFailedError naming its
                   producer, and the scheduler re-runs that map task)
    quota-breach   memory/manager.py, per quota evaluation (forces a
                   per-query quota breach, so a degradation rung)
    admit          serving/service.py, per admission decision (sheds the
                   query with QueryRejected kind="injected")
    cancel-race    serving/service.py QueryService.cancel, widens the
                   cancel-vs-completion race window
    stream-epoch   streaming/executor.py, at the start of each epoch (the
                   stream recovers from its last committed checkpoint)
    checkpoint-commit  streaming/checkpoint.py, before a manifest's link
                   (a crash between the sink attempt and the commit)

The reference's other sites (`LATER_SITES`) have no code point in the
port: a rule that names one raises ValueError naming ROADMAP Queue 1
item 16 rather than never firing.

Determinism: every decision is a pure function of (seed, site,
occurrence index): the k-th evaluation of a site fires or not whatever
thread claimed it, so a fixed seed gives a fixed fire set, the
reference's for the same rules.  Rules fire on explicit occurrence
indices (`at`) or with probability `p` drawn from a per-occurrence
`random.Random(crc32(seed|site|k))`.

Config (`auron.tpu.faults.*`): `enable` activates the injector from
`rules` and `seed` on first use; tests call `configure()` or `scoped()`.
Rule grammar, comma-separated:

    site=0.25            fire with p=0.25 per occurrence
    site=0.25*3          ... at most 3 times
    site@2+7             fire exactly on occurrences 2 and 7
    site=0.1:raise       the action, `raise` (the default) the only one:
                         the reference's `corrupt` acts only at
                         `shuffle-write`, a later site, so it raises
                         ValueError naming item 16 like one
"""

from __future__ import annotations

import binascii
import random
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

#: the sites the port evaluates
SITES = ("task-start", "shuffle-read", "quota-breach", "admit",
         "cancel-race", "stream-epoch", "checkpoint-commit")

#: the reference's sites with no code point in the port yet
LATER_SITES = ("shuffle-write", "ipc-decode", "mem-pressure",
               "device-collective", "device-loop", "pallas-kernel",
               "worker-crash",
               "worker-hang", "worker-slow",
               "speculation-loser-commit-race", "replica-crash",
               "replica-hang", "socket-torn-frame")


class FetchFailedError(RuntimeError):
    """A shuffle block could not be read back intact (Spark's
    FetchFailedException).  Carries the producer stage id and map task id
    that wrote the block."""

    def __init__(self, stage_id: int = -1, map_id: int = -1,
                 reason: str = ""):
        self.stage_id = int(stage_id)
        self.map_id = int(map_id)
        self.reason = reason
        super().__init__(
            f"shuffle fetch failed (stage={stage_id} map={map_id})"
            + (f": {reason}" if reason else ""))


class InjectedFault(RuntimeError):
    """A scripted transient failure; retryable (the analog of a lost
    executor heartbeat)."""


def classify_exception(e: BaseException) -> str:
    """'retryable' | 'fetch-failed' | 'fatal'.

    A fetch failure goes to the scheduler's lineage recovery: re-running
    the reading task would re-read the same poisoned block."""
    from blaze_tpu_torch.shuffle.ipc import ShuffleChecksumError
    if isinstance(e, FetchFailedError):
        return "fetch-failed"
    if isinstance(e, (InjectedFault, ShuffleChecksumError, EOFError,
                      ConnectionError, BrokenPipeError, InterruptedError)):
        return "retryable"
    if isinstance(e, (MemoryError, KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(e, OSError):
        return "retryable"  # transient filesystem trouble
    if type(e).__name__ == "StageLoopFallback":
        # every stage-loop caller handles the fallback in place; one that
        # leaks is retried with the loop declined (bridge/tasks.py)
        return "retryable"
    return "fatal"


# -- the injection engine ----------------------------------------------------

@dataclass
class FaultRule:
    site: str
    p: float = 0.0
    at: Tuple[int, ...] = ()       # explicit 1-based occurrence indices
    times: Optional[int] = None    # cap on total fires
    action: str = "raise"          # the one action of the port
    fires: int = 0                 # mutated under the injector lock


@dataclass
class _SiteStats:
    evals: int = 0
    fires: int = 0


class FaultInjector:
    """Seeded, counter-deterministic fault decision engine."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._rules: Dict[str, list] = {}
        self._counters: Dict[str, int] = {}
        self._stats: Dict[str, _SiteStats] = {}

    def install(self, site: str, p: float = 0.0,
                at: Iterable[int] = (), times: Optional[int] = None,
                action: str = "raise") -> None:
        rule = FaultRule(site=_check_site(site), p=float(p), at=tuple(at),
                         times=times, action=_check_action(action))
        with self._lock:
            self._rules.setdefault(site, []).append(rule)

    def decide(self, site: str) -> Optional[FaultRule]:
        """Consume one occurrence of `site`; return the firing rule (or
        None).  Deterministic in the occurrence index, not in which
        thread claimed it."""
        with self._lock:
            rules = self._rules.get(site)
            stats = self._stats.setdefault(site, _SiteStats())
            stats.evals += 1
            if not rules:
                return None
            k = self._counters.get(site, 0) + 1
            self._counters[site] = k
            for rule in rules:
                if rule.times is not None and rule.fires >= rule.times:
                    continue
                if rule.at:
                    hit = k in rule.at
                elif rule.p > 0.0:
                    # keyed by the reference's CRC-32 (binascii's gives
                    # the same values): stable across processes, where
                    # str hash() is salted; not a frame checksum
                    rng = random.Random(
                        binascii.crc32(f"{self.seed}|{site}|{k}".encode()))
                    hit = rng.random() < rule.p
                else:
                    hit = False
                if hit:
                    rule.fires += 1
                    stats.fires += 1
                    return rule
        return None

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {s: {"evals": st.evals, "fires": st.fires}
                    for s, st in self._stats.items()}


def _check_site(site: str) -> str:
    """A misspelt site would never fire, and a chaos run would pass having
    injected nothing: fail at parse time, and name the ROADMAP item for a
    site of the reference the port has no code point for."""
    if site in SITES:
        return site
    if site in LATER_SITES:
        raise ValueError(
            f"fault site {site!r} has no code point in the port yet "
            f"(ROADMAP Queue 1 item 16); the port's sites: "
            f"{', '.join(SITES)}")
    raise ValueError(f"unknown fault site {site!r}; the port's sites: "
                     f"{', '.join(SITES)}")


def _check_action(action: str) -> str:
    """`raise` is the port's one action.  The reference's `corrupt` acts
    only at `shuffle-write`, which the port lacks: elsewhere it would
    consume its occurrence and inject nothing, so it is refused."""
    if action == "raise":
        return action
    if action == "corrupt":
        raise ValueError(
            "fault action 'corrupt' acts only at shuffle-write, which has "
            "no code point in the port yet (ROADMAP Queue 1 item 16)")
    raise ValueError(f"unknown fault action {action!r}")


def parse_rules(spec: str) -> list:
    """Parse the `auron.tpu.faults.rules` grammar into (site, kwargs)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        action = "raise"
        if ":" in part:
            part, action = part.rsplit(":", 1)
            action = _check_action(action)
        times = None
        if "*" in part:
            part, times_s = part.rsplit("*", 1)
            times = int(times_s)
        if "@" in part:
            site, at_s = part.split("@", 1)
            at = tuple(int(x) for x in at_s.split("+"))
            out.append((_check_site(site.strip()),
                        dict(at=at, times=times, action=action)))
        elif "=" in part:
            site, p_s = part.split("=", 1)
            out.append((_check_site(site.strip()),
                        dict(p=float(p_s), times=times, action=action)))
        else:
            raise ValueError(f"bad fault rule {part!r} "
                             f"(want site=p or site@k)")
    return out


# -- the process-wide registry ----------------------------------------------

_lock = threading.Lock()
_injector: Optional[FaultInjector] = None
_conf_probed = False  # the lazy one-shot auron.tpu.faults.enable probe


def configure(rules: str, seed: int = 0) -> FaultInjector:
    """Replace the active injector with one built from a rule string."""
    global _injector, _conf_probed
    inj = FaultInjector(seed=seed)
    for site, kw in parse_rules(rules):
        inj.install(site, **kw)
    with _lock:
        _injector = inj
        _conf_probed = True
    return inj


def activate_from_conf() -> Optional[FaultInjector]:
    """Build the injector from `auron.tpu.faults.*` when enabled."""
    global _injector, _conf_probed
    from blaze_tpu_torch import config
    with _lock:
        _conf_probed = True
        if not config.FAULTS_ENABLE.get():
            _injector = None
            return None
        inj = FaultInjector(seed=config.FAULTS_SEED.get())
        for site, kw in parse_rules(config.FAULTS_RULES.get()):
            inj.install(site, **kw)
        _injector = inj
        return inj


def clear() -> None:
    """Deactivate injection entirely (the next use probes the conf
    again)."""
    global _injector, _conf_probed
    with _lock:
        _injector = None
        _conf_probed = False


def _current() -> Optional[FaultInjector]:
    global _conf_probed
    inj = _injector
    if inj is not None:
        return inj
    if _conf_probed:
        return None
    # the first call since clear(): honour a conf-enabled injector; the
    # probe is cached, so a hot path pays no config lookup when off
    with _lock:
        if _injector is not None:
            return _injector
        _conf_probed = True
    from blaze_tpu_torch import config
    if config.FAULTS_ENABLE.get():
        return activate_from_conf()
    return None


def _note_fire(site: str) -> None:
    from blaze_tpu_torch.bridge import device_stats, tracing
    device_stats.note_fault_injected()
    tracing.instant("fault_injected", site=site)


def maybe_fail(site: str, **ctx: Any) -> None:
    """Raise InjectedFault if a rule fires for `site`."""
    inj = _current()
    if inj is None:
        return
    if inj.decide(site) is not None:
        _note_fire(site)
        raise InjectedFault(
            f"injected fault at {site}"
            + (f" ({', '.join(f'{k}={v}' for k, v in ctx.items())})"
               if ctx else ""))


def fires(site: str, **ctx: Any) -> bool:
    """A decision that does not raise (the quota-breach and cancel-race
    sites act on it in place)."""
    inj = _current()
    if inj is None:
        return False
    if inj.decide(site) is None:
        return False
    _note_fire(site)
    return True


def stats() -> Dict[str, Dict[str, int]]:
    inj = _injector
    return inj.stats() if inj is not None else {}


class scoped:
    """`with faults.scoped(("task-start", dict(at=(1,)))): ...` installs
    rules for a block and restores the previous injector on exit."""

    def __init__(self, *rules: Tuple[str, Dict[str, Any]], seed: int = 0):
        self._rules = rules
        self._seed = seed
        self._saved: Optional[FaultInjector] = None
        self._saved_probed = False

    def __enter__(self) -> FaultInjector:
        global _injector, _conf_probed
        inj = FaultInjector(seed=self._seed)
        for site, kw in self._rules:
            inj.install(site, **kw)
        with _lock:
            self._saved, self._saved_probed = _injector, _conf_probed
            _injector, _conf_probed = inj, True
        return inj

    def __exit__(self, *exc) -> bool:
        global _injector, _conf_probed
        with _lock:
            _injector, _conf_probed = self._saved, self._saved_probed
        return False
