"""The port's checkpoint, resilience and churn pieces against the
reference's, and the port's own bitwise invariants.

* checkpoints cross between the packages both ways (through
  ``models.convert``'s naming), arrays bitwise and checksums equal;
* ``corrupt_values`` bit for bit; ``make_validated_mixer``'s drop /
  nan / inf / bitflip paths to 1e-6 (f32 matmuls on either side);
  ``make_frozen_step`` on QG-DSGDm-N and D² steps to 1e-6, its held rows
  bitwise; ``guards.update`` / ``summarize`` counters exactly,
  ``loss_ema`` to 1e-6; ``neighbor_topk_overlap`` exactly;
* at ``SMALL_CONFIG`` (8×8 images), 4 nodes, 30 steps on the CPU, all
  bitwise: telemetry and guard on = off, crash + resume = uninterrupted,
  detected-corrupt = drop, and the churned node frozen across its
  window.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint_checksum as j_checksum
from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.core import driver as jdriver
from repro.core import labeling as jlabeling
from repro.core.algorithms import make_algorithm as j_make_algorithm
from repro.core.mixing import make_mixer as j_make_mixer
from repro.core.topology import Topology as JTopology
from repro.resil import GuardSpec as JGuardSpec
from repro.resil import WireFault as JWireFault
from repro.resil import faults as jfaults
from repro.resil import guards as jguards
from repro_torch import sched
from repro_torch.checkpoint import checkpoint_checksum as t_checksum
from repro_torch.checkpoint import load_checkpoint as t_load
from repro_torch.checkpoint import save_checkpoint as t_save
from repro_torch.checkpoint.checkpoint import flatten
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
from repro_torch.core import driver as tdriver
from repro_torch.core import labeling as tlabeling
from repro_torch.core.algorithms import make_algorithm as t_make_algorithm
from repro_torch.core.mixing import make_mixer as t_make_mixer
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.core.topology import Topology as TTopology
from repro_torch.data.synthetic import (make_classification_data,
                                        make_public_data)
from repro_torch.models.convert import from_jax_params, to_jax_params
from repro_torch.obs import Telemetry
from repro_torch.resil import (GuardSpec, Resilience, SimulatedCrash,
                               SnapshotManager, WireFault, faults, guards)

from test_torch_common import leaves, resnet_tree

torch.set_num_threads(1)
N = 4


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------- checkpoints
def test_checkpoint_crosses_between_packages(tmp_path):
    """A checkpoint the reference writes loads into the port (convert's
    naming: nested HWIO -> flat OIHW) and one the port writes loads into
    the reference, bitwise, with equal checksums."""
    tree = resnet_tree(J_SMALL, seed=3, n=N)
    j_save(str(tmp_path / "jax"), tree, step=7, extra={"by": "jax"})
    like = to_jax_params(from_jax_params(tree, device="cpu"))
    got, step = t_load(str(tmp_path / "jax"), like)
    assert step == 7
    port = from_jax_params(got, device="cpu")
    for k, v in from_jax_params(tree, device="cpu").items():
        assert torch.equal(port[k], v), k
    assert t_checksum(flatten(tree)) == j_checksum(leaves(tree))

    t_save(str(tmp_path / "port"), to_jax_params(port), step=9)
    back, step = j_load(str(tmp_path / "port"), tree)
    assert step == 9
    for k, v in leaves(tree).items():
        np.testing.assert_array_equal(np.asarray(leaves(back)[k]), v)
    metas = [json.load(open(tmp_path / f"{w}.meta.json"))
             for w in ("jax", "port")]
    assert metas[0]["checksum"] == metas[1]["checksum"]
    assert metas[0]["keys"] == metas[1]["keys"]


def test_checkpoint_refusals_and_bf16(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.ones(2, 2, dtype=torch.bfloat16)},
             "opt_state": {"t": 3, "m": [torch.zeros(2)]}}
    t_save(str(tmp_path / "a"), state, step=5)
    got, step = t_load(str(tmp_path / "a"), state)
    assert step == 5 and got["opt_state"]["t"] == 3
    assert got["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    with pytest.raises(ValueError, match="structure"):
        t_load(str(tmp_path / "a"), {"params": {"w": torch.zeros(2, 3)}})
    meta = json.load(open(tmp_path / "a.meta.json"))
    np.savez(tmp_path / "a.npz", **{k: np.zeros(1) for k in meta["keys"]})
    with pytest.raises(ValueError, match="checksum"):
        t_load(str(tmp_path / "a"), state)
    meta["version"] = 0
    json.dump(meta, open(tmp_path / "a.meta.json", "w"))
    with pytest.raises(ValueError, match="version"):
        t_load(str(tmp_path / "a"), state)


def test_snapshots_skip_truncated_and_keep_generator_state(tmp_path):
    gen = torch.Generator().manual_seed(5)
    torch.rand(3, generator=gen)
    state = {"params": {"w": torch.arange(4.0)}, "key": gen.get_state()}
    mgr = SnapshotManager(tmp_path, every=0, keep=3)
    mgr.save(3, state)
    mgr.save(6, state, ctx={"pub_idx": torch.arange(4)}, phase="kd_sparse",
             fired=1)
    out = mgr.load_latest(state)
    assert out["step"] == 6 and out["phase"] == "kd_sparse"
    g2 = torch.Generator()
    g2.set_state(out["state"]["key"])
    assert torch.equal(torch.rand(5, generator=g2),
                       torch.rand(5, generator=gen))
    # a snapshot cut short by a crash is skipped
    raw = (tmp_path / "snap-00000006.npz").read_bytes()
    (tmp_path / "snap-00000006.npz").write_bytes(raw[:len(raw) // 2])
    out = mgr.load_latest(state)
    assert out["step"] == 3 and out["ctx"] is None
    mgr.save(9, state, ctx={"x": np.ones(2)})
    np.savez(tmp_path / "snap-00000009.ctx.npz", x=np.zeros(2))
    assert mgr.load_latest(state)["step"] == 3
    assert not mgr.crash_seen(4)
    mgr.mark_crash(4)
    assert mgr.crash_seen(4)


# --------------------------------------------------------------- faults
def test_corrupt_values_and_validation_match_reference():
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    x[2, 1] = 0.0
    rows = np.array([False, True, False, True])
    for mode in ("nan", "inf", "bitflip"):
        ref = np.asarray(jfaults.corrupt_values(jnp.asarray(x), mode))
        got = faults.corrupt_values(_t(x), mode).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32))
        np.testing.assert_array_equal(
            faults.corrupt_rows(_t(x), rows, mode).numpy().view(np.int32),
            np.asarray(jfaults.corrupt_rows(jnp.asarray(x), rows, mode)
                       ).view(np.int32))
        for arr in (x, ref):
            np.testing.assert_array_equal(
                faults.payload_valid(_t(arr)).numpy(),
                np.asarray(jfaults.payload_valid(jnp.asarray(arr))))


FAULTS = [dict(drop=(1,)), dict(corrupt=(2,), mode="nan"),
          dict(corrupt=(0, 2), mode="inf"), dict(corrupt=(3,),
                                                 mode="bitflip"),
          dict(drop=(0,), corrupt=(2,), mode="nan")]


@pytest.mark.parametrize("validate", [True, False])
def test_validated_mixer_matches_reference(validate):
    """Each fault of FAULTS on the masked ring (node 3 down), drop, nan,
    inf and bitflip, with validation on and off."""
    active = np.array([True, True, True, False])
    for fault, kw in enumerate(FAULTS):
        if not validate and kw.get("mode") == "bitflip":
            with pytest.raises(ValueError, match="bitflip"):
                t_make_mixer(TTopology.make("ring", N), device="cpu",
                             wire_fault=WireFault(**kw),
                             wire_guard=GuardSpec(validate_wire=False))
            continue
        rng = np.random.default_rng(fault)
        tree = {"a": rng.normal(size=(N, 3, 2)).astype(np.float32),
                "b": np.zeros((N, 5), np.float32)}
        jm = j_make_mixer(JTopology.make("ring", N), "dense",
                          wire_dtype="float32", active=active,
                          wire_fault=JWireFault(**kw),
                          wire_guard=JGuardSpec(validate_wire=validate))
        tm = t_make_mixer(TTopology.make("ring", N), wire_dtype="float32",
                          device="cpu", active=active,
                          wire_fault=WireFault(**kw),
                          wire_guard=GuardSpec(validate_wire=validate))
        jout = jm(jax.tree.map(jnp.asarray, tree))
        tout = tm({k: _t(v) for k, v in tree.items()})
        for k in tree:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{kw} {k}")
        np.testing.assert_array_equal(
            tm.wire_check({k: _t(v) for k, v in tree.items()}).numpy(),
            np.asarray(jm.wire_check(jax.tree.map(jnp.asarray, tree))))


def test_fault_free_mixer_is_unwrapped_and_corrupt_equals_drop():
    topo = TTopology.make("ring", N)
    x = {"w": torch.randn(N, 6, generator=torch.Generator().manual_seed(1))}
    plain = t_make_mixer(topo, device="cpu")
    assert not hasattr(plain, "wire_check")
    assert not hasattr(t_make_mixer(topo, device="cpu",
                                    wire_fault=WireFault()), "wire_check")
    drop = t_make_mixer(topo, device="cpu", wire_fault=WireFault(drop=(1,)))
    for mode in ("nan", "inf", "bitflip"):
        bad = t_make_mixer(topo, device="cpu",
                           wire_fault=WireFault(corrupt=(1,), mode=mode))
        assert torch.equal(bad(x)["w"], drop(x)["w"]), mode


# ---------------------------------------------------------- frozen step
@pytest.mark.parametrize("algo", ["qg-dsgdm-n", "d2"])
def test_frozen_step_matches_reference(algo):
    """Both packages' frozen steps around the algorithm's update on the
    masked mixer: the frozen node's params and state rows are held
    bitwise, the rest agree with the reference to 1e-6."""
    rng = np.random.default_rng(2)
    active = np.array([True, False, True, True])
    p0 = {"w": rng.normal(size=(N, 3, 2)).astype(np.float32),
          "b": rng.normal(size=(N, 2)).astype(np.float32)}
    gs = [{k: rng.normal(size=v.shape).astype(np.float32)
           for k, v in p0.items()} for _ in range(3)]
    ja = j_make_algorithm(algo, momentum=0.9, weight_decay=1e-4)
    ta = t_make_algorithm(algo, momentum=0.9, weight_decay=1e-4)
    jmix = j_make_mixer(JTopology.make("ring", N), "dense",
                        wire_dtype="float32", active=active)
    tmix = t_make_mixer(TTopology.make("ring", N), wire_dtype="float32",
                        device="cpu", active=active)

    def jinner(p, o, g, lr):
        np_, no = ja.step(p, g, o, lr, jmix)
        return np_, no, jnp.float32(0)

    def tinner(p, o, g, lr):
        np_, no = ta.step(p, g, o, lr, tmix)
        return np_, no, torch.zeros(())

    jinner.init_opt = ja.init
    tinner.init_opt = ta.init
    jstep = jdriver.make_frozen_step(jinner, active)
    tstep = tdriver.make_frozen_step(tinner, active)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {k: _t(v) for k, v in p0.items()}
    jo, to = ja.init(jp), ta.init(tp)
    for g in gs:
        jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, g), 0.1)
        tp, to, _ = tstep(tp, to, {k: _t(v) for k, v in g.items()}, 0.1)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
        assert np.array_equal(tp[k][1].numpy(), p0[k][1]), k
    state = to["m"] if algo == "qg-dsgdm-n" else to["prev_g"]
    for k in p0:
        assert not state[k][1].any(), k


# --------------------------------------------------------------- guards
def test_guard_update_and_summarize_match_reference():
    spec_kw = dict(loss_spike_factor=3.0, warmup_steps=2, consensus_max=5.0)
    js, ts = JGuardSpec(**spec_kw), GuardSpec(**spec_kw)
    jg, tg = jguards.init_node_guard(N), guards.init_node_guard(N,
                                                              device="cpu")
    rng = np.random.default_rng(4)
    for step in range(7):
        losses = np.full(N, 1.0 + 0.1 * step, np.float32)
        params = {"w": 0.1 * rng.normal(size=(N, 3)).astype(np.float32)}
        grads = {"w": np.zeros((N, 3), np.float32)}
        if step == 3:
            losses[1] = np.nan
            grads["w"][2, 0] = np.inf
        if step == 4:
            losses[3] = 50.0
            params["w"][0] += 10.0
        wire = np.array([False, False, step >= 5, False])
        jg = jguards.update(jg, js, jnp.asarray(losses),
                            jax.tree.map(jnp.asarray, grads),
                            jax.tree.map(jnp.asarray, params),
                            wire_invalid=jnp.asarray(wire))
        tg = guards.update(tg, ts, _t(losses),
                           {k: _t(v) for k, v in grads.items()},
                           {k: _t(v) for k, v in params.items()},
                           wire_invalid=_t(wire))
    a, b = guards.summarize(tg), jguards.summarize(jg)
    np.testing.assert_allclose(a.pop("loss_ema"), b.pop("loss_ema"),
                               rtol=1e-6)
    assert a == b
    assert a["nonfinite_loss"][1] == 1 and a["loss_spike"][3] == 1
    assert a["consensus_blowup"][0] == 1 and a["wire_invalid"][2] == 2
    assert (guards.tripped_nodes(a) == jguards.tripped_nodes(b)).all()
    assert (guards.wire_offenders(a) == jguards.wire_offenders(b)).all()
    assert guards.summarize(guards.reset(tg))["accum_steps"] == 0


def test_neighbor_topk_overlap_matches_reference():
    idx = np.random.default_rng(6).integers(0, 9, size=(N, 5, 3, 4))
    for kind in ("ring", "full", "chain"):
        got = tlabeling.neighbor_topk_overlap(_t(idx),
                                              TTopology.make(kind, N))
        ref = jlabeling.neighbor_topk_overlap(idx, JTopology.make(kind, N))
        assert got == ref, kind


# ---------------------------------------- the port's bitwise invariants
STEPS = 30


@pytest.fixture(scope="module")
def small_sim():
    data = make_classification_data(image_size=8, n_train=256, n_val=32,
                                    n_test=64, noise=1.6, seed=0)
    pub = make_public_data(data, n_public=64, kind="aligned", seed=1)
    tcfg = TrainConfig(algorithm="qg-dsgdm-n", num_nodes=N, alpha=0.1,
                       steps=STEPS, batch_size=4, lr=0.3,
                       idkd=IDKDConfig(start_step=15, temperature=10.0,
                                       label_backend="sparse",
                                       label_topk=4))
    return DecentralizedSimulator(SMALL_CONFIG.replace(image_size=8), tcfg,
                                  data, pub, kd_mode="idkd", eval_every=5,
                                  device="cpu")


def _schedule(*extra):
    events = [sched.ChurnEvent(10, down=(1,)), sched.ChurnEvent(20, up=(1,)),
              sched.RewireEvent(22, "full"), *extra]
    return sched.compile_schedule(STEPS, 5, round_steps=(15,),
                                  events=events)


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_port_invariants_bitwise(small_sim, tmp_path):
    sim = small_sim
    base = sim.run(_schedule())
    # telemetry and guard on: the same trajectory, bitwise
    tel = Telemetry(tmp_path / "tel", trace=True)
    on = sim.run(_schedule(), telemetry=tel, resil=Resilience(
        guard=GuardSpec(loss_spike_factor=100.0, consensus_max=1e6),
        snapshot_dir=str(tmp_path / "keep"), snapshot_every=0, keep=20))
    tel.close()
    assert on.loss_history == base.loss_history and _equal(on.params,
                                                           base.params)
    # the churned node is frozen across [10, 20): its params and momentum
    # in the snapshots at 10 and 20 are the same bits
    like = {"params": base.params, "opt_state": {"m": base.params},
            "key": torch.Generator().get_state()}
    snaps = {step: t_load(str(tmp_path / "keep" / f"snap-{step:08d}"),
                          like)[0] for step in (10, 20)}
    for a, b in ((snaps[10]["params"], snaps[20]["params"]),
                 (snaps[10]["opt_state"]["m"], snaps[20]["opt_state"]["m"])):
        for k in a:
            assert torch.equal(a[k][1], b[k][1]), k
            assert not torch.equal(a[k][0], b[k][0]), k
    labels = [json.loads(line) for line in open(tmp_path / "tel" /
                                                 "run.jsonl")
              if '"labels"' in line]
    assert labels[0]["selected"][1] == 0 and min(
        labels[0]["selected"][i] for i in (0, 2, 3)) > 0
    # crash after a snapshot, then resume: the uninterrupted run, bitwise
    res = Resilience(snapshot_dir=str(tmp_path / "snap"), snapshot_every=5)
    crash = _schedule(sched.FaultEvent(25, "crash"))
    with pytest.raises(SimulatedCrash):
        sim.run(crash, resil=res)
    resumed = sim.run(crash, resil=res)
    assert _equal(resumed.params, base.params)
    assert resumed.loss_history == base.loss_history[-len(
        resumed.loss_history):]
    # a detected-corrupt window equals a drop window
    runs = [sim.run(_schedule(sched.FaultEvent(4, kind, (2,), "nan"),
                              sched.FaultEvent(8, "clear")))
            for kind in ("corrupt", "drop")]
    assert _equal(runs[0].params, runs[1].params)
    assert not _equal(runs[0].params, base.params)
    # capture at the round's boundary, resume from the copy: the same end
    cap = sim.run(_schedule(), capture_at=15)
    again = sim.run(_schedule(), resume=cap.captured)
    assert _equal(again.params, base.params)


def test_rollback_quarantines_the_offender(small_sim, tmp_path):
    """A nan corruption with validation off poisons the receivers; the
    guard trips, the sender is quarantined, the segment re-runs from its
    pre-segment state, and the run stays finite."""
    r = small_sim.run(
        _schedule(sched.FaultEvent(4, "corrupt", (2,), "nan")),
        resil=Resilience(guard=GuardSpec(validate_wire=False),
                         rollback=True))
    assert all(np.isfinite(r.loss_history))
    assert all(torch.isfinite(v).all() for v in r.params.values())
    q = np.sum([row["quarantined_steps_per_node"]
                for row in r.ledger["per_round"]], axis=0)
    assert q[2] > 0 and q[[0, 1, 3]].sum() == 0
