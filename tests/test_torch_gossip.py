"""Compressed, delayed and straggler gossip and the gather/roll/auto
mixers of the port against the reference's ``repro.core.mixing``, on the
same numpy trees.

Tolerances: the mixers sum the same f32 terms, in another order where a
backend's matmul or einsum chooses one, so values agree to 1e-6; payload
index sets, schedules, ledgers and the scheduler's bookkeeping exactly.
Random-k payloads are the top-k of uniforms; the reference draws them
from ``jax.random`` and the port from a ``torch.Generator``, so the
parity tests replay the reference's uniforms through the port's
``uniform`` hook (the port's own draws are checked by its resume test,
never reseeded). No JAX simulator compile and no JAX ``run_training``:
the reference's mixers and ``make_step`` run eagerly on small trees and
a linear model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro.core import driver as jdriver
from repro.core import mixing as jm
from repro.core.algorithms import make_algorithm as j_make_algorithm
from repro.core.topology import Topology as JTopology
from repro.resil import GuardSpec as JGuard
from repro.resil.faults import WireFault as JWireFault
from repro.sched import ledger as jledger
from repro_torch import sched as tsched
from repro_torch.core import algorithms as talgos
from repro_torch.core import driver as tdriver
from repro_torch.core import mixing as tm
from repro_torch.core.topology import Topology as TTopology
from repro_torch.resil import GuardSpec as TGuard
from repro_torch.resil.faults import WireFault as TWireFault
from repro_torch.sched import ledger as tledger

import test_torch_events as E

torch.set_num_threads(1)

N = 4


def _tree(n, seed=0, scale=1.0):
    """Sorted keys, so that the port's leaf order is the reference's."""
    rng = np.random.default_rng(seed)
    return {"b": (rng.normal(size=(n, 5)) * scale).astype(np.float32),
            "c": (rng.normal(size=(n, 3, 4)) * scale).astype(np.float32),
            "w": (rng.normal(size=(n, 29)) * scale).astype(np.float32)}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def _close(got, want, what, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=what)


def _raises_alike(jcall, tcall):
    """Both raise the same message, or both return; returns the pair."""
    try:
        want = jcall()
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e)) as got:
            tcall()
        assert str(got.value) == str(e)
        return None, None
    return want, tcall()


# ----------------------------------------------------------- wire format
SPECS = [None, "none", ("none", 0.5), "topk", "topk:0.1", ("randk", 0.05),
         ("topk", 1), "randk:0.3", "lz4", ("topk", 0.0), "topk:1.5"]


@pytest.mark.parametrize("spec", SPECS, ids=[str(s) for s in SPECS])
def test_compression_spec_and_payload_count_match_reference(spec):
    """normalize_compression, and payload_elem_count on a node-stacked
    tree and one node's, as tests/test_compression.py pins them."""
    want, got = _raises_alike(lambda: jm.normalize_compression(spec),
                              lambda: tm.normalize_compression(spec))
    assert got == want
    if want is None and spec not in (None, "none", ("none", 0.5)):
        return
    tree = _tree(N)
    for stacked in (True, False):
        t = tree if stacked else {k: v[0] for k, v in tree.items()}
        assert tm.payload_elem_count(_t(t), spec, node_stacked=stacked) \
            == jm.payload_elem_count(_j(t), spec, node_stacked=stacked)


@pytest.mark.parametrize("size,frac", [(29, 0.5), (5, 0.5), (100, 0.01),
                                       (100, 1.0), (3, 0.01), (2, 0.25),
                                       (51_200_000, 0.01), (7, 0.5)])
def test_payload_k_keeps_bankers_round(size, frac):
    assert tm.payload_k(size, frac) == jm.payload_k(size, frac)


# --------------------------------------------------- stateless backends
MIX_CASES = [(topo, n, backend, masked)
             for topo, n in (("ring", 6), ("chain", 5), ("social", 15),
                             ("ring", 2))
             for backend in ("gather", "roll", "auto", "dense")
             for masked in (False, True)]


@pytest.mark.parametrize(
    "topo,n,backend,masked", MIX_CASES,
    ids=[f"{t}{n}-{b}" + ("-masked" if m else "") for t, n, b, m in MIX_CASES])
def test_stateless_backends_match_reference(topo, n, backend, masked):
    """gather / roll / auto (and dense beside them) on rings, a chain and
    the Florentine graph, with and without a churn mask, in f32 and bf16
    storage: the reference's values, and its refusals (roll off a ring
    or under a mask) with its messages."""
    jt, tt = JTopology.make(topo, n), TTopology.make(topo, n)
    active = None
    if masked:
        active = np.ones(n, bool)
        active[1] = False
    x = _tree(n, seed=n)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want, got = _raises_alike(
            lambda: jm.make_mixer(jt, backend, active=active)(
                {k: jnp.asarray(v).astype(jdt) for k, v in x.items()}),
            lambda: tm.make_mixer(tt, backend, device="cpu", active=active)(
                {k: torch.as_tensor(v).to(tdt) for k, v in x.items()}))
        if want is None:
            return
        for k in x:
            _close(got[k].float().numpy(), np.asarray(want[k], np.float32),
                   f"{topo} {backend} {k} {tdt}",
                   atol=1e-6 if tdt == torch.float32 else 1e-2)
            if tdt == torch.bfloat16:   # one rounding of the same f32 sum
                assert got[k].dtype == torch.bfloat16


# ---------------------------------------------------- the stateful mixer
def _ref_uniforms(jcomm, i, flat):
    """The reference's random-k uniforms of leaf ``i`` for the step its
    comm state ``jcomm`` is about to take."""
    _, use = jm._split_node_keys(jcomm["key"])
    lk = jm._fold_leaf(use, i)
    return np.asarray(jax.vmap(
        lambda kk: jax.random.uniform(kk, (flat,)))(lk))


def _stateful_pair(topo, backend, n, kw, fault=None, guard=None):
    """The same stateful mixer in both packages; the port's random-k
    draws replay the reference's (``box["comm"]``, its comm state before
    the step, set by the caller)."""
    box = {}
    jt, tt = JTopology.make(topo, n), TTopology.make(topo, n)
    jmix = jm.make_compressed_mixer(
        jt, backend, **kw,
        wire_fault=None if fault is None else JWireFault(**fault),
        wire_guard=None if guard is None else JGuard(**guard))
    tmix = tm.make_compressed_mixer(
        tt, backend, device="cpu", **kw,
        wire_fault=None if fault is None else TWireFault(**fault),
        wire_guard=None if guard is None else TGuard(**guard),
        uniform=lambda i, shape: np.array(
            _ref_uniforms(box["comm"], i, shape[1])))
    return jmix, tmix, box


STATEFUL_CASES = {
    "topk-sync": ("ring", "dense", dict(compression=("topk", 0.2))),
    "topk-delayed": ("ring", "dense", dict(compression=("topk", 0.2),
                                           gossip="delayed")),
    "topk-gamma": ("chain", "gather", dict(compression=("topk", 0.3),
                                           consensus_lr=0.5)),
    "randk-sync": ("ring", "dense", dict(compression=("randk", 0.3))),
    "randk-delayed": ("ring", "auto", dict(compression=("randk", 0.3),
                                           gossip="delayed")),
    "none-delayed": ("ring", "roll", dict(gossip="delayed")),
    "none-stale": ("ring", "dense", dict(stale=np.array([0, 1, 0, 0],
                                                        bool))),
    "topk-stale": ("ring", "auto", dict(compression=("topk", 0.2),
                                        stale=np.array([0, 0, 1, 0], bool))),
    "topk-stale-masked": ("ring", "gather", dict(
        compression=("topk", 0.25), gossip="delayed",
        stale=np.array([0, 0, 1, 0], bool),
        active=np.array([1, 0, 1, 1], bool))),
    "topk-drop-corrupt": ("ring", "dense", dict(compression=("topk", 0.2))),
    "randk-inf": ("ring", "dense", dict(compression=("randk", 0.3))),
}
FAULTS = {"topk-drop-corrupt": (dict(drop=(1,), corrupt=(3,), mode="nan"),
                                dict(max_abs=1e8)),
          "randk-inf": (dict(corrupt=(0,), mode="inf"),
                            dict(max_abs=10.0))}


# the port's mixer works on row and column blocks of CHUNK elements
# (Hymba-width leaves); CHUNK 16 cuts these leaves into many
CHUNKED = ("topk-sync", "randk-delayed", "topk-stale-masked")
STATEFUL_RUNS = [(c, None) for c in sorted(STATEFUL_CASES)] + \
    [(c, 16) for c in CHUNKED]


@pytest.mark.parametrize(
    "case,chunk", STATEFUL_RUNS,
    ids=[c + ("-chunked" if k else "") for c, k in STATEFUL_RUNS])
def test_stateful_mixer_three_steps_match_reference(case, chunk,
                                                    monkeypatch):
    """make_compressed_mixer over 3 steps on moving params: before each
    step the payload index sets equal (the same selection on the same
    x − x̂), after it y and x̂ (or prev) within 1e-6 — top-k, random-k
    (the reference's uniforms replayed), none × sync / delayed, stale
    stragglers (whose x̂ rows never move), a churn mask, wire faults on
    the payloads; some with the port's blocks cut small."""
    if chunk is not None:
        monkeypatch.setattr(tm, "CHUNK", chunk)
    topo, backend, kw = STATEFUL_CASES[case]
    fault, guard = FAULTS.get(case, (None, None))
    jmix, tmix, box = _stateful_pair(topo, backend, N, kw, fault, guard)
    base = _tree(N, seed=1)
    jcomm, tcomm = jmix.init_state(_j(base)), tmix.init_state(_t(base))
    comp = kw.get("compression")
    stale = kw.get("stale")
    for s in range(3):
        x = {k: v + (s + 1) * _tree(N, seed=10 + s, scale=0.3)[k]
             for k, v in base.items()}
        if comp is not None:
            kind, frac = comp
            for i, k in enumerate(sorted(x)):
                flat = int(np.prod(x[k].shape[1:]))
                d = x[k].reshape(N, flat) - np.asarray(tcomm["hat"][k])
                kk = jm.payload_k(flat, frac)
                lk = (jm._fold_leaf(jm._split_node_keys(jcomm["key"])[1], i)
                      if kind == "randk" else None)
                _, jidx = jm._select_payload(jnp.asarray(d), kind, kk, lk)
                r = (torch.as_tensor(np.array(_ref_uniforms(jcomm, i, flat)))
                     if kind == "randk" else None)
                _, tidx = tm._select_payload(torch.as_tensor(d), kind, kk, r)
                np.testing.assert_array_equal(
                    tidx.numpy(), np.sort(np.asarray(jidx), axis=1),
                    err_msg=f"step {s} leaf {k} payload indices")
        before = ({k: v.clone() for k, v in tcomm["hat"].items()}
                  if comp is not None else None)
        box["comm"] = jcomm
        jb = jmix.bind(jcomm)
        jy = jb(_j(x))
        jcomm = jb.finalize()
        tb = tmix.bind(tcomm)
        ty = tb(_t(x))
        tcomm = tb.finalize()
        name = "prev" if comp is None else "hat"
        for k in x:
            _close(ty[k].numpy(), jy[k], f"step {s} y {k}")
            _close(tcomm[name][k].numpy(), jcomm[name][k],
                   f"step {s} {name} {k}")
            if stale is not None and comp is not None:
                # the straggler's estimate rows stay where they were
                assert torch.equal(tcomm["hat"][k][stale],
                                   before[k][stale])


@pytest.mark.parametrize("n,seed", [(3, 0), (4, 1), (2, 2)])
def test_topk_ties_break_to_the_lowest_index(n, seed):
    """Integer magnitudes with exact ties across the k-th value (and both
    signs of each): the selected indices are lax.top_k's."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 5, size=(n, 61)) * rng.choice([-1, 1],
                                                       size=(n, 61))
         ).astype(np.float32)
    for k in (1, 2, 7, 13, 30, 60, 61):
        _, jidx = jax.lax.top_k(jnp.abs(jnp.asarray(d)), k)
        tidx = tm.topk_indices(torch.as_tensor(d).abs(), k)
        np.testing.assert_array_equal(tidx.numpy(),
                                      np.sort(np.asarray(jidx), axis=1))
        _, tsel = tm._select_payload(torch.as_tensor(d), "topk", k)
        _, jsel = jm._select_payload(jnp.asarray(d), "topk", k)
        np.testing.assert_array_equal(tsel.numpy(),
                                      np.sort(np.asarray(jsel), axis=1))


def test_topk_full_fraction_and_uncompressed_sync_are_the_plain_mix():
    """frac 1 and γ 1 recover the dense mix within f32 rounding; the
    stateful uncompressed sync mixer is bitwise the plain one."""
    tt = TTopology.make("ring", N)
    x = _t(_tree(N, seed=4))
    plain = tm.make_mixer(tt, "dense", device="cpu")(x)
    for kw, exact in ((dict(compression=("topk", 1.0)), False),
                      (dict(stateful=True), True)):
        mix = tm.make_mixer(tt, "dense", device="cpu", **kw)
        b = mix.bind(mix.init_state(x))
        y = b(x)
        b.finalize()
        for k in x:
            if exact:
                assert torch.equal(y[k], plain[k]), k
            else:
                _close(y[k].numpy(), plain[k].numpy(), k)


def test_recorder_and_refusals_match_reference():
    """The bound mixer raises on more or fewer leaf mixes than the tree
    has and on a direct call; faults on the uncompressed stateful path,
    validate_wire=False on compressed wires, an unknown gossip mode and
    gradient tracking under a stateful mixer raise the reference's
    messages."""
    jt, tt = JTopology.make("ring", N), TTopology.make("ring", N)
    x = _tree(N)
    for pkg, topo, tree in ((jm, jt, _j(x)), (tm, tt, _t(x))):
        kw = {"device": "cpu"} if pkg is tm else {}
        mix = pkg.make_mixer(topo, "dense", compression=("topk", 0.5), **kw)
        with pytest.raises(TypeError, match="bind"):
            mix(tree)
        bound = mix.bind(mix.init_state(tree))
        bound(tree)
        with pytest.raises(ValueError, match="more leaves"):
            bound.mix_leaf(tree["b"])
        partial = mix.bind(mix.init_state(tree))
        partial.mix_leaf(tree["b"])
        with pytest.raises(ValueError, match="never mixed"):
            partial.finalize()
    for kw in (dict(gossip="delayed", wire_fault=("drop", (1,))),
               dict(compression=("topk", 0.1), wire_fault=("drop", (1,)),
                    wire_guard=dict(validate_wire=False)),
               dict(gossip="async")):
        def build(pkg, topo, Fault, Guard, extra):
            args = dict(kw)
            if "wire_fault" in args:
                args["wire_fault"] = Fault(drop=args["wire_fault"][1])
            if "wire_guard" in args:
                args["wire_guard"] = Guard(**args["wire_guard"])
            return pkg.make_mixer(topo, "dense", **args, **extra)
        _raises_alike(lambda: build(jm, jt, JWireFault, JGuard, {}),
                      lambda: build(tm, tt, TWireFault, TGuard,
                                    {"device": "cpu"}))
    mix = tm.make_mixer(tt, "dense", device="cpu", compression=("topk", 0.5))
    gt = talgos.make_algorithm("gradient-tracking")
    p = _t(x)
    with pytest.raises(ValueError, match="more leaves"):
        gt.step(p, p, gt.init(p), 0.1, mix.bind(mix.init_state(p)))


# --------------------------------------- make_step: whole-leaf mixing
class _JLinear:
    """A linear classifier of flattened images, per node (the reference's
    step vmaps the loss over nodes)."""

    def forward(self, params, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        return x @ params["w"] + params["b"], None


class _TLinear:
    """The same on node-stacked params and batches."""

    def forward(self, params, batch):
        img = batch["images"]
        x = img.reshape(img.shape[0], img.shape[1], -1)
        return torch.einsum("nbd,ndc->nbc", x, params["w"]) \
            + params["b"][:, None], None


STEP_MIXERS = {"none-delayed": dict(gossip="delayed"),
               "topk-sync": dict(compression=("topk", 0.1)),
               "topk-delayed": dict(compression=("topk", 0.1),
                                    gossip="delayed"),
               "randk-sync": dict(compression=("randk", 0.1)),
               "topk-stale": dict(compression=("topk", 0.1),
                                  stale=np.array([0, 1, 0, 0], bool))}


@pytest.mark.parametrize("name", sorted(STEP_MIXERS))
def test_make_step_qg_with_stateful_mixer_matches_reference(name,
                                                            monkeypatch):
    """Two make_step steps of QG-DSGDm-N with each stateful mixer, the
    metrics bus's EF residual on, against the reference's make_step on a
    linear model whose weight (24 x 5) is cut into slices (CHUNK forced
    to 16, and the metrics bus's blocks too): the port mixes whole
    leaves, so params, momentum, the comm state and the EF residual
    match."""
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics
    monkeypatch.setattr(talgos, "CHUNK", 16)
    monkeypatch.setattr(tmetrics, "CHUNK", 16)
    rng = np.random.default_rng(5)
    params = {"b": (rng.normal(size=(N, 5)) * 0.1).astype(np.float32),
              "w": (rng.normal(size=(N, 24, 5)) * 0.3).astype(np.float32)}
    jmix, tmix, box = _stateful_pair("ring", "dense", N, STEP_MIXERS[name])
    ja = j_make_algorithm("qg-dsgdm-n", momentum=0.9, weight_decay=1e-4)
    ta = talgos.make_algorithm("qg-dsgdm-n", momentum=0.9,
                               weight_decay=1e-4)
    jstep = jdriver.make_step(_JLinear(), ja, jmix,
                              jdriver.classification_adapter, telemetry=True)
    tstep = tdriver.make_step(_TLinear(), ta, tmix,
                              tdriver.classification_adapter, telemetry=True)
    assert jstep.comm and tstep.comm
    jp, tp = _j(params), _t(params)
    jopt, topt = ja.init(jp), ta.init(tp)
    jcomm, tcomm = jstep.init_comm(jp), tstep.init_comm(tp)
    jmet = jmetrics.init_node_metrics(N)
    tmet = tmetrics.init_node_metrics(N, "cpu")
    for s in range(2):
        imgs = rng.normal(size=(N, 6, 2, 4, 3)).astype(np.float32)
        y = rng.integers(0, 5, size=(N, 6))
        batch = {"images": imgs, "labels": np.eye(5, dtype=np.float32)[y],
                 "weights": np.ones((N, 6), np.float32)}
        box["comm"] = jcomm
        jp, jopt, jl, jcomm, jmet = jstep(jp, jopt, _j(batch),
                                          jnp.float32(0.2), jcomm, jmet)
        tp, topt, tl, tcomm, tmet = tstep(tp, topt, _t(batch), 0.2, tcomm,
                                          tmet)
        _close(float(tl), float(jl), f"step {s} loss")
        for k in params:
            _close(tp[k].numpy(), jp[k], f"step {s} params {k}")
            _close(topt["m"][k].numpy(), jopt["m"][k], f"step {s} m {k}")
        state = "prev" if "compression" not in STEP_MIXERS[name] else "hat"
        for k in params:
            _close(tcomm[state][k].numpy(), jcomm[state][k],
                   f"step {s} {state} {k}")
        for f in ("ef_sq", "consensus_sq", "grad_sq_sum"):
            _close(tmet[f].numpy(), jmet[f], f"step {s} {f}", atol=1e-5)
        assert float(tmet["ef_sq"].sum()) > 0


# --------------------------------------------- schedule, ledger, runs
@pytest.mark.parametrize("gossip", ["sync", "delayed"])
def test_delayed_schedule_and_stale_churn_match_reference(gossip):
    events = (("churn", 2, (1,), (), "stale"), ("churn", 5, (2,), (),
                                                "freeze"),
              ("churn", 8, (), (1,), "stale"))
    out = {}
    for side in E.SIDES:
        s = E.SIDES[side]["sched"]
        sch = s.compile_schedule(E.STEPS, E.EVAL, round_steps=(6,),
                                 events=E._events(side, events),
                                 gossip=gossip)
        out[side] = (E._segments(sch), sch.gossip, sch.has_stale)
    assert out["port"] == out["ref"]
    assert out["port"][2]


def test_ledger_bytes_match_reference():
    """gossip_bytes_per_step with compressed payloads (value + int32
    index) and stale senders charged 0, on a ring and the Florentine
    graph, against the reference, and the payload formula to the byte."""
    for topo, n in (("ring", 6), ("social", 15)):
        jt, tt = JTopology.make(topo, n), TTopology.make(topo, n)
        rng = np.random.default_rng(n)
        for _ in range(4):
            active = rng.random(n) > 0.2
            stale = rng.random(n) > 0.7
            for kw in ({}, dict(payload_elems=123, index_bytes=4),
                       dict(payload_elems=7, index_bytes=4, stale=stale)):
                want = jledger.gossip_bytes_per_step(jt, active, 1000, 2,
                                                     **kw)
                got = tledger.gossip_bytes_per_step(tt, active, 1000, 2,
                                                    **kw)
                np.testing.assert_array_equal(got, want)
                deg = np.array([sum(active[j] for j in tt.neighbors(i))
                                if active[i] else 0 for i in range(n)])
                if "stale" in kw:
                    deg = np.where(stale, 0, deg)
                elems = kw.get("payload_elems", 1000)
                np.testing.assert_array_equal(
                    got, deg * elems * (2 + kw.get("index_bytes", 0)))


def _stale_run(side, tmp):
    s = E.SIDES[side]
    hooks = E.StubHooks(side, telemetry=True)
    events = (("churn", 2, (1,), (), "stale"), ("churn", 5, (3,), (),
                                                "isolate"),
              ("churn", 8, (), (1, 3), "stale"))
    schedule = s["sched"].compile_schedule(
        E.STEPS, E.EVAL, round_steps=(6,), events=E._events(side, events),
        gossip="delayed")
    tel = s["obs"].Telemetry(tmp / side)
    ledger = s["sched"].CommLedger(E.N)
    try:
        p, _, key, _ = s["sched"].run_schedule(
            schedule, hooks, {"w": np.linspace(0, 1, E.N * 3, dtype=np.float32
                                               ).reshape(E.N, 3)},
            {}, np.zeros(2, np.uint32), topology=s["Topology"].make(
                "ring", E.N), ledger=ledger, param_count=3, elem_bytes=4,
            payload_elems=2, index_bytes=4, telemetry=tel)
    finally:
        tel.close()
    return {"final": np.asarray(p["w"]).tolist(), "calls": hooks.calls,
            "ledger": ledger.as_dict(),
            "events": E._tag_metrics(
                [{k: v for k, v in e.items() if k != "t"}
                 for e in E.tobs.read_events(tmp / side / "run.jsonl")])}


def test_stale_run_schedule_matches_reference_with_stub_hooks(tmp_path):
    """A delayed-gossip schedule with stale stragglers (and an isolated
    node) through both schedulers and the stub hooks: the same hook
    calls (stale masks in on_topology), ledger rows (stale senders at 0
    bytes, STATUS_STALE steps, compressed payload bytes) and run log."""
    ref, port = (_stale_run(side, tmp_path) for side in ("ref", "port"))
    E._same(port, ref)
    rows = port["ledger"]["per_round"]
    assert sum(r["stale_steps_per_node"][1] for r in rows) == 6
    assert any(c[0] == "on_topology" and c[4][1] for c in port["calls"])


def test_resume_with_compressed_comm_is_bitwise(tmp_path):
    """A 4-node ResNet run with top-k and random-k gossip crashes after a
    durable snapshot and resumes from it (params, momentum, the samplers'
    generator and the comm state, random-k's generator too): the final
    params are bitwise the uninterrupted run's; the simulator refuses a
    schedule whose gossip mode differs from its config's."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
    from repro_torch.core.simulator import DecentralizedSimulator
    from repro_torch.data.synthetic import make_classification_data
    from repro_torch.resil import Resilience, SimulatedCrash
    data = make_classification_data(image_size=8, n_train=64, n_val=8,
                                    n_test=16)
    cfg = SMALL_CONFIG.replace(image_size=8, cnn_stages=(1, 1))
    for comp, gossip in (("topk", "sync"), ("randk", "delayed")):
        tcfg = TrainConfig(num_nodes=N, steps=8, batch_size=4,
                           compression=comp, compression_frac=0.05,
                           gossip=gossip)
        sim = DecentralizedSimulator(cfg, tcfg, data, eval_every=3,
                                     device="cpu")
        if comp == "topk":
            with pytest.raises(ValueError, match="gossip"):
                sim.run(tsched.compile_schedule(8, 3, gossip="delayed"))
        whole = sim.run().params
        sch = tsched.compile_schedule(8, 3, gossip=gossip, events=(
            tsched.FaultEvent(5, "crash"),))
        resil = Resilience(snapshot_dir=str(tmp_path / comp))
        with pytest.raises(SimulatedCrash):
            sim.run(sch, resil=resil)
        again = sim.run(sch, resil=resil).params
        for k in whole:
            assert torch.equal(again[k], whole[k]), (comp, k)
