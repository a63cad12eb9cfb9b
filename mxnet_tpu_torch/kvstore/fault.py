"""Fault-injection plans and the recovery backoff schedule (the port's
copy of ``mxnet_tpu/kvstore/fault.py``, whole: the plan grammar, its
native installers, the backoff clock, the straggler seam and the
recovery telemetry; the checkpoint, lending and decode-recovery kinds
parse here as in the JAX package and wait for their planes to read
them).

The deterministic-fault half of the KVStore robustness layer: a plan
string in ``MXNET_KVSTORE_FAULT_PLAN`` describes WHICH faults to
provoke at WHICH protocol points, e.g.::

    drop_conn@round=3;delay_ms=500@key=0;kill_server@round=5

Each ``;``-separated directive is ``kind[=arg]`` followed by
``@cond=val`` conditions. Kinds:

``drop_conn``
    (client seam) close the connection instead of sending the matching
    request. Without ``round=`` it fires on EVERY match — a permanent
    fault; with ``round=N`` it fires once, at the Nth matching request.
``delay_ms=<ms>``
    (client or server seam) sleep before the matching request/response.
``trunc_frame``
    (client seam) send a torn frame — full header, half the payload —
    then drop the connection.
``kill_server``
    (server seam) raise SIGTERM in the server process when a key
    completes its Nth merge round (``round=N``; pin one key with
    ``key=K``, else the first key to reach round N fires it — with
    uniform BSP pushes every key's count IS the BSP round number, so
    this is model-size independent): the graceful-death path
    (run_server's handler snapshots state and exits, tools/launch.py
    ``--restart-policy=server`` restarts it).
``die_server``
    (server seam) ``_exit(86)`` at the same per-key round point —
    abrupt death, no snapshot.
``reject_accept=<count>``
    (server accept seam) close the next ``count`` accepted connections
    before rendezvous (exercises connect retry).
``kill_worker``
    (worker checkpoint seam, Python-side) SIGTERM THIS worker when its
    global batch counter reaches ``batch=N`` (checkpoint.py
    PreemptionGuard.batch_done; the counter is restored on resume, so a
    fired kill never refires after its own recovery).
``trunc_checkpoint`` / ``corrupt_checkpoint``
    (checkpoint write seam, Python-side) truncate / flip one byte of
    the Nth atomic checkpoint write (``round=N``, default the next one)
    AFTER its CRC is recorded — the torn-write/bitrot damage the
    MANIFEST.json must reject at load.
``slow_worker=<ms>``
    (worker loop seam, Python-side) the named rank (``rank=N``)
    sleeps ``ms`` of extra compute every batch, via
    :func:`apply_straggler` called inside the step span by the
    elastic train loop / chaos driver — the deterministic straggler
    whose rank PR 5's trace_merge report must name.
``borrow_wedge``
    (lending seam, Python-side) the borrower of lent training chips
    takes the lease but never reports ready (``round=N`` = the Nth
    lend; no round = every lend) — drives the LendingScheduler's
    lease-revocation path in cluster/lending.py.
``reclaim_timeout=<ms>``
    (lending seam, Python-side) the borrower drains slowly on reclaim:
    inject ``ms`` of extra drain latency into the Nth reclaim
    (``round=N``; no round = every reclaim), bounded by the reclaim
    backoff budget.
``migrate_wedge``
    (decode-recovery seam, Python-side) the Nth KV-block migration
    attempt (``round=N``; no round = every attempt) wedges mid-copy —
    the KVMigrator raises before landing blocks, forcing the recovery
    path to fall back to deterministic replay on the surviving lane.
``replay_storm``
    (decode-recovery seam, Python-side) salvage is skipped entirely
    for the Nth recovery round (``round=N``; no round = every
    recovery): every evacuated request replays prompt + accepted
    tokens from scratch — the device-truly-gone worst case.

Conditions: ``round=N`` (Nth distinct matching request, counted PER
RANK so interleaving across workers cannot move the firing point, and
a resend of the same request never re-advances the count; for
kill/die rules: a key's Nth completed merge round), ``key=K``,
``op=<init|push|pull|pull_rows|barrier|command>``, ``rank=R`` (only
workers with DMLC_WORKER_ID == R install the rule), ``server=S``
(only server S installs it), ``batch=N`` (kill_worker only: the
worker's global batch counter value to preempt at).
A ``round=``-conditioned client rule defaults to
``op=push`` — "round" means a BSP round, and the client opens one with
its push. Unknown kinds or conditions raise ``MXNetError`` — a typo'd
plan silently injecting nothing would be worse than no plan.

The recovery half lives in :class:`BackoffSchedule` (exponential
backoff with deterministic-seedable jitter under a total budget — the
client-side retry clock, unit-testable on a fake clock) and
:class:`RecoveryTelemetry` (what happened, surfaced through
profiler.py so the bench supervisor can report WHY a run degraded).
"""
from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field

from ..base import MXNetError

# mirror of the comm.cc constants (kFault*)
KIND_CODES = {
    "drop_conn": 1,
    "delay_ms": 2,
    "trunc_frame": 3,
    "kill_server": 4,
    "reject_accept": 5,
    "die_server": 6,
}
SERVER_KINDS = ("kill_server", "die_server", "reject_accept")
# Python-side checkpoint/preemption faults (mxnet_tpu/checkpoint.py):
# they never reach the native transport seams — install_client_rules /
# install_server_rules skip them. ``kill_worker@batch=N`` raises SIGTERM
# in the worker when its GLOBAL batch counter (PreemptionGuard, restored
# on resume) hits N; ``trunc_checkpoint``/``corrupt_checkpoint`` mutate
# the Nth atomic checkpoint write (``round=N``, default next) after its
# CRC is recorded, modelling the torn-write/bitrot damage the manifest
# must reject at load.
CHECKPOINT_KINDS = ("kill_worker", "trunc_checkpoint", "corrupt_checkpoint")
# Python-side straggler injection (ROADMAP item 4): ``slow_worker=MS@
# rank=N`` makes rank N sleep MS milliseconds of extra "compute" every
# batch, consumed by :func:`apply_straggler` inside the step span (the
# elastic train loop and the chaos driver both call it) — so PR 5's
# trace_merge straggler report must NAME that exact rank by its
# non-comm work. Never reaches the native seams either.
STRAGGLER_KINDS = ("slow_worker",)
# Python-side device-lending faults (mxnet_tpu/cluster/lending.py):
# ``borrow_wedge[@round=N]`` makes the Nth lend's borrower take the
# lease but never report ready (no round= — every lend), driving the
# LendingScheduler.check_leases revocation path; ``reclaim_timeout=MS
# [@round=N]`` injects a slow borrower drain of MS milliseconds into
# the Nth reclaim, which the reclaim backoff budget must bound. Like
# the straggler kinds they never reach the native seams.
LENDING_KINDS = ("borrow_wedge", "reclaim_timeout")
# Python-side decode-recovery faults (serving/generate/migrate.py):
# ``migrate_wedge[@round=N]`` wedges the Nth KV-block migration attempt
# mid-copy (no round= — every attempt), forcing the fallback to
# deterministic replay; ``replay_storm[@round=N]`` disables salvage for
# the Nth recovery round entirely, so every evacuated generation
# replays prompt + accepted tokens — the device-truly-gone worst case.
# Never reach the native seams.
DECODE_KINDS = ("migrate_wedge", "replay_storm")
# wire op codes (comm.cc kInit..kPullRows)
OP_CODES = {
    "init": 1,
    "push": 2,
    "pull": 3,
    "barrier": 4,
    "command": 5,
    "push_2bit": 6,
    "pull_rows": 7,
}
_CONDS = ("round", "key", "op", "rank", "server", "batch")


@dataclass
class FaultRule:
    kind: str
    arg: int = 0            # delay ms / reject count
    round: int | None = None
    key: int | None = None
    op: str | None = None
    rank: int | None = None
    server: int | None = None
    batch: int | None = None  # kill_worker: global batch to die at

    @property
    def is_server_side(self) -> bool:
        return self.kind in SERVER_KINDS or (
            self.kind == "delay_ms" and self.server is not None)

    @property
    def is_checkpoint_side(self) -> bool:
        return self.kind in CHECKPOINT_KINDS

    @property
    def is_python_side(self) -> bool:
        """Rules consumed by Python seams (checkpoint writes, the
        preemption guard, the straggler sleep, the lending protocol's
        wedge/timeout seams, the decode-recovery migrate/replay
        seams) — the native installers must skip them."""
        return self.kind in CHECKPOINT_KINDS or \
            self.kind in STRAGGLER_KINDS or \
            self.kind in LENDING_KINDS or \
            self.kind in DECODE_KINDS


def parse_fault_plan(plan: str) -> list[FaultRule]:
    """Parse a ``MXNET_KVSTORE_FAULT_PLAN`` string into FaultRules.

    Raises MXNetError on unknown kinds/conditions or malformed values —
    fault plans exist to make tests deterministic, so a bad plan must
    fail loudly, never silently inject nothing.
    """
    rules = []
    for directive in filter(None, (d.strip() for d in plan.split(";"))):
        head, *conds = directive.split("@")
        kind, _, argtxt = head.partition("=")
        kind = kind.strip()
        if kind not in KIND_CODES and kind not in CHECKPOINT_KINDS \
                and kind not in STRAGGLER_KINDS \
                and kind not in LENDING_KINDS \
                and kind not in DECODE_KINDS:
            raise MXNetError(
                f"unknown fault kind {kind!r} in MXNET_KVSTORE_FAULT_PLAN "
                f"directive {directive!r} (known: "
                f"{sorted(KIND_CODES) + sorted(CHECKPOINT_KINDS) + sorted(STRAGGLER_KINDS) + sorted(LENDING_KINDS) + sorted(DECODE_KINDS)})")
        rule = FaultRule(kind=kind)
        if argtxt:
            try:
                rule.arg = int(argtxt)
            except ValueError:
                raise MXNetError(
                    f"fault {directive!r}: argument {argtxt!r} is not an "
                    "integer") from None
        elif kind == "delay_ms":
            raise MXNetError(
                f"fault {directive!r}: delay_ms needs a value, e.g. "
                "delay_ms=500")
        elif kind == "reject_accept":
            rule.arg = 1
        elif kind == "slow_worker":
            raise MXNetError(
                f"fault {directive!r}: slow_worker needs a delay in "
                "ms, e.g. slow_worker=40@rank=1")
        elif kind == "reclaim_timeout":
            raise MXNetError(
                f"fault {directive!r}: reclaim_timeout needs a delay "
                "in ms, e.g. reclaim_timeout=800@round=1")
        if kind in ("borrow_wedge",) + DECODE_KINDS and argtxt:
            raise MXNetError(
                f"fault {directive!r}: {kind} takes no value "
                "(condition it with @round=N instead)")
        for cond in conds:
            name, eq, val = cond.partition("=")
            name = name.strip()
            if name not in _CONDS or not eq:
                raise MXNetError(
                    f"unknown fault condition {cond!r} in {directive!r} "
                    f"(known: {_CONDS})")
            if name == "op":
                if val not in OP_CODES:
                    raise MXNetError(
                        f"fault {directive!r}: unknown op {val!r} "
                        f"(known: {sorted(OP_CODES)})")
                rule.op = val
            else:
                try:
                    setattr(rule, name, int(val))
                except ValueError:
                    raise MXNetError(
                        f"fault {directive!r}: condition {name}={val!r} "
                        "is not an integer") from None
        if rule.kind in ("kill_server", "die_server") and rule.round is None:
            raise MXNetError(
                f"fault {directive!r}: {rule.kind} needs round=N (the "
                "merge round to die at)")
        if rule.kind == "kill_worker" and rule.batch is None:
            raise MXNetError(
                f"fault {directive!r}: kill_worker needs batch=N (the "
                "global batch to preempt at)")
        if rule.batch is not None and rule.kind != "kill_worker":
            raise MXNetError(
                f"fault {directive!r}: batch=N only applies to "
                "kill_worker")
        if rule.is_python_side:
            # the contract is fail-loudly: a condition the Python-side
            # seams never read must not be silently dropped
            allowed = {"kill_worker": ("batch", "rank"),
                       "trunc_checkpoint": ("round", "rank"),
                       "corrupt_checkpoint": ("round", "rank"),
                       "slow_worker": ("rank",),
                       "borrow_wedge": ("round",),
                       "reclaim_timeout": ("round",),
                       "migrate_wedge": ("round",),
                       "replay_storm": ("round",)}[rule.kind]
            ignored = [c for c in _CONDS
                       if getattr(rule, c) is not None and c not in allowed]
            if ignored:
                raise MXNetError(
                    f"fault {directive!r}: condition(s) {ignored} do not "
                    f"apply to {rule.kind} (allowed: {list(allowed)})")
        if (rule.round is not None and rule.op is None
                and not rule.is_server_side and not rule.is_python_side):
            # "round" on a client rule means a BSP round, which the
            # client opens with its push
            rule.op = "push"
        rules.append(rule)
    return rules


def plan_from_env() -> list[FaultRule]:
    return parse_fault_plan(os.environ.get("MXNET_KVSTORE_FAULT_PLAN", ""))


def install_client_rules(lib, rules, worker_rank=None):
    """Program the native client seams with the worker-side rules.

    ``worker_rank`` filters ``rank=``-conditioned rules (taken from
    DMLC_WORKER_ID when None). Returns how many rules were installed.
    """
    if worker_rank is None:
        worker_rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
    n = 0
    for r in rules:
        if r.is_server_side or r.is_python_side:
            continue
        if r.rank is not None and r.rank != worker_rank:
            continue
        lib.mxtpu_fault_client_add(
            KIND_CODES[r.kind], OP_CODES.get(r.op, 0) if r.op else 0,
            r.key if r.key is not None else -1,
            r.round if r.round is not None else -1, r.arg)
        n += 1
    return n


def install_server_rules(lib, rules, server_id=None):
    """Program the native server seams (kill/die/reject/delay rules)."""
    if server_id is None:
        server_id = int(os.environ.get("DMLC_SERVER_ID", "0"))
    n = 0
    for r in rules:
        if not r.is_server_side or r.is_python_side:
            continue
        if r.server is not None and r.server != server_id:
            continue
        lib.mxtpu_fault_server_add(
            KIND_CODES[r.kind], OP_CODES.get(r.op, 0) if r.op else 0,
            r.key if r.key is not None else -1,
            r.round if r.round is not None else -1, r.arg)
        n += 1
    return n


class BackoffSchedule:
    """Exponential backoff with jitter under a total recovery budget.

    The client-side retry clock: ``next_wait()`` returns how long to
    sleep before the next reconnect attempt (None once the budget is
    exhausted), growing ``base_ms * 2^attempt`` capped at ``max_ms``,
    jittered by ±``jitter`` fraction so N workers retrying the same
    dead server don't stampede its restart in lockstep. ``clock`` and
    ``rng`` are injectable for tests (a fake clock makes the whole
    schedule assertable without sleeping).
    """

    def __init__(self, budget_ms, base_ms=50, max_ms=2000, jitter=0.25,
                 clock=time.monotonic, rng=None):
        if budget_ms <= 0:
            raise MXNetError("BackoffSchedule needs a positive budget")
        self.budget_ms = float(budget_ms)
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.jitter = float(jitter)
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self._t0 = clock()
        self.attempts = 0
        self.total_wait_ms = 0.0

    def elapsed_ms(self):
        return (self._clock() - self._t0) * 1000.0

    def remaining_ms(self):
        return self.budget_ms - self.elapsed_ms()

    def exhausted(self):
        return self.remaining_ms() <= 0

    def next_wait(self):
        """Seconds to sleep before the next attempt, or None when the
        budget is spent. Waits never overshoot the budget: the last one
        is clipped to the remaining window."""
        remaining = self.remaining_ms()
        if remaining <= 0:
            return None
        raw = min(self.base_ms * (2.0 ** self.attempts), self.max_ms)
        jit = 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        wait_ms = min(raw * jit, remaining)
        self.attempts += 1
        self.total_wait_ms += wait_ms
        return wait_ms / 1000.0


# -- straggler seam (Python-side) -----------------------------------------
# parsed slow_worker rules cached per plan string: apply_straggler runs
# once per training batch, so it must cost a dict probe, not a re-parse
_STRAGGLER_CACHE = {}  # plan string -> {rank or None: delay_ms}


def straggler_delay_ms(worker_rank=None, plan=None):
    """Delay in ms the plan's ``slow_worker`` rules impose on this rank
    (0.0 when none match). ``worker_rank`` defaults to DMLC_WORKER_ID;
    ``plan`` defaults to MXNET_KVSTORE_FAULT_PLAN."""
    if plan is None:
        plan = os.environ.get("MXNET_KVSTORE_FAULT_PLAN", "")
    if not plan:
        return 0.0
    if worker_rank is None:
        worker_rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
    by_rank = _STRAGGLER_CACHE.get(plan)
    if by_rank is None:
        by_rank = {}
        for r in parse_fault_plan(plan):
            if r.kind == "slow_worker":
                by_rank[r.rank] = by_rank.get(r.rank, 0) + r.arg
        _STRAGGLER_CACHE[plan] = by_rank
    return float(by_rank.get(int(worker_rank),
                             by_rank.get(None, 0)))


def apply_straggler(worker_rank=None, plan=None):
    """Sleep this rank's ``slow_worker`` delay (inside the caller's
    step span, so the extra wall-clock lands as COMPUTE in the
    trace_merge per-rank breakdown — a fast peer's matching wait lands
    as comm, which is exactly how the straggler report names the slow
    rank). Returns the ms slept (0.0 = no matching rule)."""
    ms = straggler_delay_ms(worker_rank, plan)
    if ms > 0:
        time.sleep(ms / 1000.0)
    return ms


# -- device-lending seams (Python-side) -----------------------------------
# parsed borrow_wedge / reclaim_timeout rules cached per plan string,
# same discipline as the straggler cache: the lending protocol probes
# these on every lend/reclaim, so it must cost a dict lookup
_LENDING_CACHE = {}  # plan string -> {"wedge": [...], "reclaim": [...]}


def _lending_rules(plan):
    if plan is None:
        plan = os.environ.get("MXNET_KVSTORE_FAULT_PLAN", "")
    if not plan:
        return {"wedge": [], "reclaim": []}
    rules = _LENDING_CACHE.get(plan)
    if rules is None:
        rules = {"wedge": [], "reclaim": []}
        for r in parse_fault_plan(plan):
            if r.kind == "borrow_wedge":
                rules["wedge"].append(r)
            elif r.kind == "reclaim_timeout":
                rules["reclaim"].append(r)
        _LENDING_CACHE[plan] = rules
    return rules


def borrow_wedge_active(lend_round=None, plan=None):
    """Whether the plan's ``borrow_wedge`` rules wedge this lend (the
    1-based ``lend_round``). A rule without ``round=`` wedges every
    lend; with ``round=N`` only the Nth. ``plan`` defaults to
    MXNET_KVSTORE_FAULT_PLAN."""
    for r in _lending_rules(plan)["wedge"]:
        if r.round is None or r.round == lend_round:
            return True
    return False


def reclaim_delay_ms(reclaim_round=None, plan=None):
    """Injected borrower-drain delay in ms for the 1-based
    ``reclaim_round`` (0.0 when no ``reclaim_timeout`` rule matches;
    rules without ``round=`` hit every reclaim)."""
    ms = 0.0
    for r in _lending_rules(plan)["reclaim"]:
        if r.round is None or r.round == reclaim_round:
            ms += r.arg
    return ms


# -- decode-recovery seams (Python-side) ----------------------------------
# parsed migrate_wedge / replay_storm rules cached per plan string, the
# same discipline as the lending cache: the decode recovery path probes
# these on every migration attempt / recovery round
_DECODE_CACHE = {}  # plan string -> {"wedge": [...], "storm": [...]}


def _decode_rules(plan):
    if plan is None:
        plan = os.environ.get("MXNET_KVSTORE_FAULT_PLAN", "")
    if not plan:
        return {"wedge": [], "storm": []}
    rules = _DECODE_CACHE.get(plan)
    if rules is None:
        rules = {"wedge": [], "storm": []}
        for r in parse_fault_plan(plan):
            if r.kind == "migrate_wedge":
                rules["wedge"].append(r)
            elif r.kind == "replay_storm":
                rules["storm"].append(r)
        _DECODE_CACHE[plan] = rules
    return rules


def migrate_wedge_active(attempt=None, plan=None):
    """Whether the plan's ``migrate_wedge`` rules wedge this KV-block
    migration (the 1-based ``attempt``). A rule without ``round=``
    wedges every attempt; with ``round=N`` only the Nth. ``plan``
    defaults to MXNET_KVSTORE_FAULT_PLAN."""
    for r in _decode_rules(plan)["wedge"]:
        if r.round is None or r.round == attempt:
            return True
    return False


def replay_storm_active(recovery_round=None, plan=None):
    """Whether the plan's ``replay_storm`` rules disable KV salvage for
    this 1-based ``recovery_round`` (rules without ``round=`` hit every
    recovery) — the device-truly-gone case, forced."""
    for r in _decode_rules(plan)["storm"]:
        if r.round is None or r.round == recovery_round:
            return True
    return False


@dataclass
class RecoveryTelemetry:
    """What the recovery protocol did — the structured answer to "why
    did this distributed run degrade". Recorded into the profiler
    stream (category ``kvstore_recovery``) and kept on the connection
    for direct inspection."""
    attempts: int = 0            # resend attempts (incl. the final one)
    reconnects: int = 0          # successful re-rendezvous count
    backoff_wait_ms: float = 0.0
    recovered: int = 0           # requests that eventually succeeded
    exhausted: int = 0           # requests that burned the whole budget
    last_op: str = ""
    last_req_id: int = 0         # round at failure (request watermark)
    last_error: str = ""
    events: list = field(default_factory=list)  # (op, req_id, outcome)
