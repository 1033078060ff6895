"""Decentralized LM training against the reference on the CPU: the LM
loss adapters, ``DecoderModel.loss``'s gradients, one train step
(``make_train_step``) and a 4-step ``run_training`` with one IDKD round,
on a reduced Hymba (3 layers, GQA 4:2, layer 1 windowed at 16 so that
24 tokens + 8 meta tokens cross it, f32).

The reference runs ``run_training`` once (host runner, 4 nodes on a
ring, 2 plain steps, the round, 2 sparse-KD steps), starting from the
port's ``init`` weights ("replay, don't reseed"), and every train step
records through ``jax.debug.callback`` its params and momentum in and
out, its batch, its mean loss and the per-node gradients the algorithm
receives. The port is held to those records step by step, and its own
``run_training`` replays the reference's index draws (recovered from the
recorded batches) and ends where the reference's does.

Tolerances: losses 1e-5 relative (one f32 forward), gradients 2e-4 of
each leaf's max |grad| (3 f32 layers, sums reordered), params after one
step 1e-5 and momentum 1e-4 (the normalized update divides by a global
norm), after 4 steps (two of them KD at T = 10, whose T²-scaled loss is
~600) params 1e-4 and the loss history 1e-4 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
from repro.configs.base import IDKDConfig as JIDKD
from repro.configs.base import TrainConfig as JTrain
from repro.core import driver as jdriver
from repro.data.synthetic import make_lm_data as j_make_lm_data
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.core import driver as tdriver
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models.convert import to_jax_lm_params
from repro_torch.models.transformer import DecoderModel

from test_torch_common import hymba_small, leaves, t

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4
STEP_PARAM_ATOL, STEP_MOM_ATOL = 1e-5, 1e-4
RUN_PARAM_ATOL, RUN_LOSS_RTOL = 1e-4, 1e-4
N_NODES, SEQ_LEN, N_SEQS, N_PUBLIC = 4, 24, 64, 8
IDKD_KW = dict(label_topk=8, stream_microbatch=8, start_step=2,
               num_rounds=1, label_backend="sparse")
TRAIN_KW = dict(num_nodes=N_NODES, steps=4, lr=0.1, batch_size=2)
RUN_KW = dict(seq_len=SEQ_LEN, n_seqs=N_SEQS, n_public=N_PUBLIC,
              log_every=1, use_idkd=True, verbose=False,
              driver_mode="host")


def _cfg(side):
    return hymba_small(side).replace(sliding_window=16)


def _port_weights():
    """One node's weights from the port's init (the run's seed 4)."""
    return DecoderModel(_cfg("torch")).init(JTrain().seed, "cpu")


@pytest.fixture(scope="module")
def reference_run():
    """The reference's run_training with every step recorded."""
    records, grads = [], []
    make_step, make_algorithm = jdriver.make_step, jtrain.make_algorithm
    build_model = jtrain.build_model
    weights = jax.tree.map(jnp.asarray, to_jax_lm_params(_port_weights()))

    def host(*a):
        return jax.tree.map(np.asarray, a)

    def recording_step(*a, **kw):
        inner = make_step(*a, **kw)

        def step(params, opt_state, batch, lr, *rest):
            out = inner(params, opt_state, batch, lr, *rest)
            jax.debug.callback(lambda *v: records.append(host(*v)), params,
                               opt_state, batch, out[0], out[1], out[2])
            return out
        for attr in ("comm", "metrics", "guard", "init_opt"):
            if hasattr(inner, attr):
                setattr(step, attr, getattr(inner, attr))
        return step

    def recording_algorithm(*a, **kw):
        algo = make_algorithm(*a, **kw)

        def step(params, g, state, lr, mix):
            jax.debug.callback(lambda v: grads.append(host(v)[0]), g)
            return algo.step(params, g, state, lr, mix)
        return dataclasses.replace(algo, step=step)

    def replayed_model(cfg):
        model = build_model(cfg)
        model.init = lambda key: weights
        return model

    jdriver.make_step = recording_step
    jtrain.make_algorithm = recording_algorithm
    jtrain.build_model = replayed_model
    # XLA's optimization passes take most of the reference's compile time
    # on the CPU and change no result here beyond f32 rounding
    fast = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        out = jtrain.run_training(
            _cfg("jax"), JTrain(**TRAIN_KW, idkd=JIDKD(**IDKD_KW)), **RUN_KW)
    finally:
        jax.config.update("jax_disable_most_optimizations", fast)
        jdriver.make_step = make_step
        jtrain.make_algorithm = make_algorithm
        jtrain.build_model = build_model
    assert len(records) == 4 and len(grads) == 4
    return out, records, grads


def _torch_tree(tree):
    return {k: t(v) for k, v in leaves(tree).items()}


def _batch(rec):
    return {k: t(v) for k, v in rec[2].items()}


def test_lm_adapters_match_reference(reference_run):
    """lm_adapter (plain step 0) and lm_sparse_kd_adapter (KD step 2, T²-
    scaled, weighted by pub_w) on the recorded params and batches: the
    mean node loss is the reference step's loss."""
    _, records, _ = reference_run
    model = DecoderModel(_cfg("torch"))
    for i, adapter in ((0, tdriver.lm_adapter),
                       (2, tdriver.lm_sparse_kd_adapter(TIDKD(**IDKD_KW)))):
        rec = records[i]
        with torch.no_grad():
            losses = adapter(model)(_torch_tree(rec[0]), _batch(rec))
        assert losses.shape == (N_NODES,)
        assert float(losses.mean()) == pytest.approx(float(rec[5]),
                                                     rel=LOSS_RTOL)
    assert float(records[2][5]) > 100        # T² = 100 times a soft CE


@pytest.mark.parametrize("remat", [False, True])
def test_decoder_loss_grads_match_reference(reference_run, remat):
    """DecoderModel.loss's gradient on every leaf of every node against
    the per-node gradients the reference's plain step 0 hands to its
    algorithm (jax.grad of the same loss, vmapped over the nodes), with
    the per-layer recompute off and on."""
    _, records, grads = reference_run
    model = DecoderModel(_cfg("torch").replace(remat=remat))
    params = {k: v.requires_grad_(True)
              for k, v in _torch_tree(records[0][0]).items()}
    loss, _ = model.loss(params, _batch(records[0]))
    got = torch.autograd.grad(loss.sum(), list(params.values()))
    ref = leaves(grads[0])
    for k, g in zip(params, got):
        scale = float(np.abs(ref[k]).max())
        assert scale > 0 and bool(torch.isfinite(g).all()), k
        assert float((g - t(ref[k])).abs().max()) <= GRAD_TOL * scale, k


def test_train_step_matches_reference(reference_run):
    """make_train_step's step from the recorded step-0 params, momentum
    and batch: the params and momentum after it (in place), and the
    metrics dict's loss."""
    _, records, _ = reference_run
    rec = records[0]
    step = make_train_step(DecoderModel(_cfg("torch")),
                           TTrain(**TRAIN_KW), N_NODES, device="cpu")
    params, opt = _torch_tree(rec[0]), {"m": _torch_tree(rec[1]["m"])}
    new_p, new_o, metrics = step(params, opt, _batch(rec), 0.1)
    assert set(metrics) == {"loss"}
    assert float(metrics["loss"]) == pytest.approx(float(rec[5]),
                                                   rel=LOSS_RTOL)
    assert new_p["embed"].data_ptr() == params["embed"].data_ptr()  # in place
    for k, v in leaves(rec[3]).items():
        np.testing.assert_allclose(new_p[k].numpy(), v,
                                   atol=STEP_PARAM_ATOL, err_msg=k)
    for k, v in leaves(rec[4]["m"]).items():
        np.testing.assert_allclose(new_o["m"][k].numpy(), v,
                                   atol=STEP_MOM_ATOL, err_msg=k)


def _replayed_draws(records):
    """The reference's index draws, recovered from its recorded batches:
    private rows by matching token rows, public rows likewise."""
    tokens, _ = j_make_lm_data(_cfg("jax").vocab_size, SEQ_LEN + 1, N_SEQS,
                               seed=JTrain().seed)
    public, _ = j_make_lm_data(_cfg("jax").vocab_size, SEQ_LEN, N_PUBLIC,
                               num_topics=10, seed=JTrain().seed + 99)
    priv_row = {r[:-1].tobytes(): i for i, r in enumerate(tokens)}
    pub_row = {r.tobytes(): i for i, r in enumerate(public)}
    assert len(priv_row) == len(tokens) and len(pub_row) == len(public)
    priv, pub = [], []
    for rec in records:
        b = rec[2]
        priv.append(np.array([[priv_row[s.tobytes()] for s in node]
                              for node in b["tokens"]]))
        if "pub_tokens" in b:
            pub.append(np.array([[pub_row[s.tobytes()] for s in node]
                                 for node in b["pub_tokens"]]))
    return priv, pub


def test_run_training_matches_reference(reference_run, monkeypatch):
    """The port's run_training on the same config, weights and index
    draws: the loss after every step within RUN_LOSS_RTOL, the round
    fired once at step 2 and the KD phase ran after it (T²-scaled
    losses), the ledger's label and gossip bytes equal, the consensus
    params within RUN_PARAM_ATOL."""
    out, records, _ = reference_run
    priv, pub = _replayed_draws(records)

    def sample_partition(parts, gen, batch_size):
        return torch.as_tensor(priv.pop(0), device=parts.idx.device)

    def draw_public(gen, n, pub_batch, n_public, device):
        return torch.as_tensor(pub.pop(0), device=device)

    monkeypatch.setattr(tdriver, "sample_partition", sample_partition)
    monkeypatch.setattr(tdriver, "draw_public", draw_public)
    mine = ttrain.run_training(
        _cfg("torch"), TTrain(**TRAIN_KW, idkd=TIDKD(**IDKD_KW)),
        device="cpu", **RUN_KW)
    assert not priv and not pub                     # every draw replayed
    ref_hist = out["loss_history"]
    assert len(mine["loss_history"]) == len(ref_hist) == 4
    np.testing.assert_allclose(mine["loss_history"], ref_hist,
                               rtol=RUN_LOSS_RTOL)
    assert min(ref_hist[2:]) > 100 > max(ref_hist[:2])   # KD after step 2
    assert mine["schedule"].round_steps == (2,)
    assert mine["last_round"]["id_fraction"] > 0
    for key in ("label_bytes", "gossip_bytes"):
        assert mine["ledger"][key] == out["ledger"][key], key
    assert mine["ledger"]["label_bytes"] > 0
    ref_params = leaves(jax.tree.map(np.asarray, out["params"]))
    for k, v in mine["params"].items():
        np.testing.assert_allclose(v.numpy(), ref_params[k],
                                   atol=RUN_PARAM_ATOL, err_msg=k)


def test_unported_training_modes_raise():
    """The sharded driver, stale stragglers and compressed or delayed
    gossip raise, naming the ROADMAP item."""
    from repro_torch.sched import ChurnEvent
    cfg = _cfg("torch")
    tcfg = TTrain(**TRAIN_KW)
    for kw in ({"driver_mode": "shard"},
               {"events": [ChurnEvent(1, down=(0,), mode="stale")]}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ttrain.run_training(cfg, tcfg, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.run_training(cfg, dataclasses.replace(tcfg, gossip="delayed"),
                            device="cpu")
