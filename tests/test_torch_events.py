"""The port's schedule events and scheduler against the reference's.

The schedule compiler and the CLI parsers are compared on the same
inputs. ``run_schedule`` runs on both sides with the same stub hooks:
plain Python runners over small node-stacked state (numpy params, the
side's own guard and metrics dicts), so the reference's scheduler runs
without a jit. The two must make the same hook calls, ledger rows,
run-log events (timestamps aside), snapshots, quarantine and rollback
decisions and crash points. Metrics events, whose floats are f32 sums
taken by JAX on one side and torch on the other, are held to 1e-6
relative; every other field is compared exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import sched as jsched
from repro.core.topology import Topology as JTopology
from repro.obs import metrics as jmetrics
from repro.resil import GuardSpec as JGuardSpec
from repro.resil import Resilience as JResilience
from repro.resil import SimulatedCrash as JCrash
from repro.resil import guards as jguards
from repro_torch import obs as tobs
from repro_torch import sched as tsched
from repro_torch.core.topology import Topology as TTopology
from repro_torch.obs import metrics as tmetrics
from repro_torch.resil import GuardSpec as TGuardSpec
from repro_torch.resil import Resilience as TResilience
from repro_torch.resil import SimulatedCrash as TCrash
from repro_torch.resil import guards as tguards

torch.set_num_threads(1)

N, STEPS, EVAL = 4, 12, 3

SIDES = {
    "ref": dict(sched=jsched, Topology=JTopology, obs=jobs,
                metrics=jmetrics, guards=jguards, Guard=JGuardSpec,
                Resil=JResilience, Crash=JCrash, arr=jnp.asarray, dev={}),
    "port": dict(sched=tsched, Topology=TTopology, obs=tobs,
                 metrics=tmetrics, guards=tguards, Guard=TGuardSpec,
                 Resil=TResilience, Crash=TCrash,
                 arr=lambda a: torch.as_tensor(np.asarray(a)),
                 dev={"device": "cpu"}),
}


def _events(side, spec):
    """The schedule events of ``spec`` (tuples) built with ``side``'s
    classes."""
    s = SIDES[side]["sched"]
    out = []
    for kind, *args in spec:
        if kind == "churn":
            step, down, up, mode = args
            out.append(s.ChurnEvent(step, down=down, up=up, mode=mode))
        elif kind == "rewire":
            out.append(s.RewireEvent(*args))
        else:
            out.append(s.FaultEvent(args[0], kind, *args[1:]))
    return out


def _segments(schedule):
    return [(seg.start, seg.stop, seg.eval_after,
             [(type(ev).__name__, {k: (v if not hasattr(v, "name") else
                                       v.name) for k, v in vars(ev).items()})
              for ev in seg.events])
            for seg in schedule.segments]


EVENT_SETS = {
    "none": (),
    "churn": (("churn", 3, (1,), (), "freeze"), ("churn", 7, (), (1,),
                                                 "freeze"),
              ("churn", 5, (2,), (), "isolate")),
    "rewire": (("rewire", 6, "full"), ("rewire", 9, "ring")),
    "faults": (("drop", 2, (1,)), ("clear", 4), ("corrupt", 5, (2,), "nan"),
               ("crash", 10)),
    "mixed": (("churn", 4, (3,), (), "freeze"), ("rewire", 4, "chain"),
              ("corrupt", 4, (0, 2), "bitflip"), ("clear", 8, (0,))),
}


@pytest.mark.parametrize("name", sorted(EVENT_SETS))
def test_compile_schedule_with_events_matches_reference(name):
    out = {}
    for side in SIDES:
        sc = SIDES[side]["sched"].compile_schedule(
            STEPS, EVAL, round_steps=(4, 8),
            events=_events(side, EVENT_SETS[name]))
        out[side] = (_segments(sc), sc.round_steps, sc.has_faults,
                     sc.boundaries())
        for step in range(STEPS):
            for ctx in (False, True):
                try:
                    sc.validate_resume(step, with_ctx=ctx)
                    ok = True
                except ValueError:
                    ok = False
                out[side] += ((step, ctx, ok),)
    assert out["port"] == out["ref"]


PARSE_CASES = [
    ("3@2-8,1@5", "churn"), ("0@0-11", "churn"), ("3@2-", "churn"),
    ("3@a-4", "bad"), ("9@2-8", "bad"), ("1@8-2", "bad"), ("x", "bad"),
    ("corrupt@8/2/nan,crash@10,clear@11", "faults"),
    ("drop@5/0+3,corrupt@6/1/bitflip", "faults"), ("drop@5/7", "bad_f"),
    ("boom@3", "bad_f"), ("drop@x", "bad_f"), ("crash@12", "bad_f")]


def test_parse_churn_and_faults_match_reference():
    for spec, kind in PARSE_CASES:
        out = {}
        for side in SIDES:
            s = SIDES[side]["sched"]
            parse = (s.parse_faults if kind in ("faults", "bad_f")
                     else s.parse_churn)
            try:
                out[side] = [vars(ev) for ev in parse(spec, N, STEPS)]
            except ValueError:
                out[side] = "ValueError"
        assert out["port"] == out["ref"], spec
        assert (out["port"] == "ValueError") == kind.startswith("bad"), spec


BAD_EVENTS = [
    (("churn", 12, (1,), (), "freeze"),), (("churn", 2, (), (), "freeze"),),
    (("churn", 2, (1,), (), "sleep"),), (("drop", 2, ()),),
    (("corrupt", 2, (1,), "gamma"),), (("boom", 2, (1,)),)]


def test_event_validation_matches_reference():
    for events in BAD_EVENTS:
        for side in SIDES:
            with pytest.raises(ValueError):
                SIDES[side]["sched"].compile_schedule(
                    STEPS, EVAL, events=_events(side, events))


def test_stale_churn_and_delayed_gossip_raise_naming_item_12():
    """Stale churn and delayed gossip were refused until ROADMAP.md's
    item 12 was ported; they now compile as the reference's do (the
    runs are in tests/test_torch_gossip.py), and an unknown gossip mode
    raises as there."""
    events = [("churn", 2, (1,), (), "stale")]
    for gossip in ("sync", "delayed"):
        out = {side: SIDES[side]["sched"].compile_schedule(
                   STEPS, EVAL, events=_events(side, events), gossip=gossip)
               for side in SIDES}
        assert _segments(out["port"]) == _segments(out["ref"])
        assert out["port"].gossip == gossip and out["port"].has_stale
    for side in SIDES:
        with pytest.raises(ValueError, match="unknown gossip mode"):
            SIDES[side]["sched"].compile_schedule(STEPS, EVAL,
                                                  gossip="async")


# ------------------------------------------------- run_schedule, stubbed
class StubHooks:
    """The same federation hooks for either scheduler: records every
    call; its runner moves numpy params a deterministic step and feeds
    the side's own metrics and guard updates. A ``corrupt`` wire fault
    with validation off poisons the corrupt senders' neighbours' losses,
    and with a guard on the corrupt senders are reported as invalid."""

    def __init__(self, side, telemetry=False, guard=None):
        self.s = SIDES[side]
        self.calls = []
        self.phase = "plain"
        self.ctx = None
        self.telemetry = None
        self.resil = None
        self.wire_fault = None
        self.last_round_stats = None
        self._metrics = telemetry
        self._guard = guard

    def init_comm(self, params, topology, schedule):
        self.calls.append(("init_comm", topology.name))
        return None

    def init_metrics(self, params, topology):
        self.calls.append(("init_metrics",))
        return (self.s["metrics"].init_node_metrics(N, **self.s["dev"])
                if self._metrics else None)

    def init_guard(self, params, topology):
        self.calls.append(("init_guard",))
        return (self.s["guards"].init_node_guard(N, **self.s["dev"])
                if self._guard is not None else None)

    def restore_ctx(self, ctx, phase):
        self.calls.append(("restore_ctx", phase,
                           {k: np.asarray(v).tolist() for k, v in
                            ctx.items()}))
        self.ctx, self.phase = ctx, phase

    def on_topology(self, topology, active, frozen, stale):
        self.calls.append(("on_topology", topology.name, active.tolist(),
                           frozen.tolist(), stale.tolist()))

    def on_segment(self, segment, index):
        self.calls.append(("on_segment", index, segment.start,
                           segment.stop))

    def on_round(self, params, round_index, step, topology, active):
        self.calls.append(("on_round", round_index, step, topology.name,
                           active.tolist(),
                           np.round(np.asarray(params["w"]), 5).tolist()))
        self.phase = "kd"
        self.ctx = {"w": np.arange(N, dtype=np.float32) * (round_index + 1)}
        sel = np.where(active, 10 + round_index, 0)
        self.last_round_stats = {"selected": sel,
                                 "id_fraction": float(sel.mean() / 20)}
        return (sel * 8).astype(np.float64)

    def on_labels(self, round_index, step, stats):
        self.calls.append(("on_labels", round_index, step))

    def on_eval(self, params, step, losses):
        self.calls.append(("on_eval", step,
                           np.round(np.asarray(params["w"]), 5).tolist()))

    def runner(self, topology, active, frozen, stale):
        self.calls.append(("runner", self.phase, topology.name,
                           active.tolist(), frozen.tolist()))
        W = topology.mixing_matrix(None if active.all() else active)
        wf = self.wire_fault
        spec = self._guard
        corrupt = np.zeros(N, bool)
        if wf is not None:
            corrupt[list(wf.corrupt)] = True
        victims = ((W * (1 - np.eye(N))) @ corrupt) > 0
        poison = corrupt.any() and spec is not None \
            and not spec.validate_wire
        arr = self.s["arr"]
        bonus = (0.0 if self.ctx is None
                 else np.asarray(self.ctx["w"], np.float32)[:, None])

        def run(p, o, k, s0, ns, metrics=None, guard=None):
            w = np.asarray(p["w"], np.float32)
            losses = []
            for t in range(int(s0), int(s0) + ns):
                new = (W @ w).astype(np.float32) * np.float32(0.9) \
                    + np.float32(0.01 * (t + 1)) + np.float32(0.001) * bonus
                w = np.where(frozen[:, None], w, new).astype(np.float32)
                loss = (1.0 / (1.0 + t) + 0.01 * np.arange(N)).astype(
                    np.float32)
                if poison:
                    loss = np.where(victims, np.nan, loss).astype(
                        np.float32)
                losses.append(loss.mean())
                if metrics is not None:
                    metrics = self.s["metrics"].update(
                        metrics, arr(loss), {"w": arr(np.ones_like(w))},
                        {"w": arr(w)})
                if guard is not None:
                    guard = self.s["guards"].update(
                        guard, spec, arr(loss), {"w": arr(np.zeros_like(w))},
                        {"w": arr(w)},
                        wire_invalid=arr(corrupt) if corrupt.any()
                        else None)
            out = ({"w": w}, o, np.asarray(k) + ns,
                   np.asarray(losses, np.float32))
            if self._metrics:
                out += (metrics,)
            if spec is not None:
                out += (guard,)
            return out

        run.metrics = bool(self._metrics)
        run.guard = spec is not None
        return run


SCENARIOS = {
    "churn_rewire": dict(events=EVENT_SETS["churn"]
                         + (("rewire", 6, "full"),), telemetry=True),
    "faults_guard": dict(events=(("drop", 2, (1,)), ("clear", 4),
                                 ("corrupt", 5, (2,), "nan")),
                         telemetry=True, guard={}),
    "rollback": dict(events=(("corrupt", 5, (2,), "nan"),), telemetry=True,
                     guard={"validate_wire": False}, rollback=True),
    "crash_resume": dict(events=(("churn", 2, (3,), (), "freeze"),
                                 ("crash", 7),
                                 ("churn", 9, (), (3,), "freeze")),
                         telemetry=True, snapshots=True),
}


def _run(side, scenario, tmp, attempt=0):
    sc = SCENARIOS[scenario]
    s = SIDES[side]
    guard = (s["Guard"](**sc["guard"]) if "guard" in sc else None)
    hooks = StubHooks(side, telemetry=sc.get("telemetry", False),
                      guard=guard)
    resil = None
    if guard is not None or sc.get("snapshots"):
        resil = s["Resil"](guard=guard, rollback=sc.get("rollback", False),
                           snapshot_dir=(str(tmp / side / "snap")
                                         if sc.get("snapshots") else None),
                           snapshot_every=3, keep=2)
    schedule = s["sched"].compile_schedule(
        STEPS, EVAL, round_steps=(4, 8), events=_events(side, sc["events"]))
    teldir = tmp / side / f"tel{attempt}"
    tel = s["obs"].Telemetry(teldir) if sc.get("telemetry") else None
    topo = s["Topology"].make("ring", N)
    ledger = s["sched"].CommLedger(N)
    params = {"w": np.linspace(0, 1, N * 3, dtype=np.float32).reshape(N, 3)}
    out = {"crash": None}
    try:
        p, _, key, _ = s["sched"].run_schedule(
            schedule, hooks, params, {}, np.zeros(2, np.uint32),
            topology=topo, ledger=ledger, param_count=3, elem_bytes=4,
            telemetry=tel, resil=resil)
        out["final"] = (np.asarray(p["w"]).tolist(), np.asarray(key).tolist())
    except (JCrash, TCrash) as e:
        out["crash"] = e.step
    finally:
        if tel is not None:
            tel.close()
    out["calls"] = hooks.calls
    out["ledger"] = ledger.as_dict()
    if tel is not None:
        out["events"] = [{k: v for k, v in e.items() if k != "t"}
                         for e in tobs.read_events(teldir / "run.jsonl")]
    if sc.get("snapshots"):
        snap = tmp / side / "snap"
        out["files"] = sorted(f.name for f in snap.iterdir())
    return out


def _same(a, b, path=""):
    """Exact equality, with the metrics events' floats to 1e-6."""
    if isinstance(a, dict) and isinstance(b, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}/{i}")
    elif isinstance(a, float) and isinstance(b, float) and \
            "metrics" in path:
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12,
                                   err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _tag_metrics(events):
    return [{("metrics" if e["ev"] == "metrics" else "ev"): e}
            for e in events]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_run_schedule_matches_reference_with_stub_hooks(scenario, tmp_path):
    runs = {side: _run(side, scenario, tmp_path) for side in SIDES}
    ref, port = runs["ref"], runs["port"]
    if "events" in ref:
        ref["events"] = _tag_metrics(ref["events"])
        port["events"] = _tag_metrics(port["events"])
    _same(port, ref)
    kinds = [list(e.values())[0]["ev"] for e in port.get("events", [])]
    if scenario == "rollback":
        assert "rollback" in kinds
        q = np.sum([r["quarantined_steps_per_node"]
                    for r in port["ledger"]["per_round"]], axis=0)
        assert q[2] > 0 and q[[0, 1, 3]].sum() == 0
    if scenario == "faults_guard":
        assert any(list(e.values())[0].get("action") == "quarantine"
                   for e in port["events"])
    if scenario == "crash_resume":
        assert ref["crash"] == port["crash"] == 7
        again = {side: _run(side, scenario, tmp_path, attempt=1)
                 for side in SIDES}
        for side in again:
            again[side]["events"] = _tag_metrics(again[side]["events"])
        _same(again["port"], again["ref"])
        assert again["port"]["crash"] is None
        assert any(c[0] == "restore_ctx" for c in again["port"]["calls"])
        resume = [e for e in again["port"]["events"]
                  if list(e.values())[0]["ev"] == "resume"]
        assert list(resume[0].values())[0]["step"] == 7
    json.dumps(port["ledger"])
