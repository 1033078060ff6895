"""The port's telemetry (``repro_torch.obs``) against the reference's.

The run-log schema is the reference's; each package's validators accept
the other's run logs and traces, and the reference's ``repro.obs.check``
passes the port's files. ``metrics.update`` / ``summarize`` agree with
the reference's to 1e-6 relative on the same node-stacked inputs (f32
sums on either side), and ``sqrt(sum(consensus_sq))`` is
``mixing.consensus_distance`` to 1e-6. LM training with telemetry and
the guard on runs the trajectory of the run without them, bitwise.
"""
import dataclasses
import io
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.obs import EVENT_SCHEMA as J_SCHEMA
from repro.obs import check as jcheck
from repro.obs import metrics as jmetrics
from repro.obs import validate_runlog as j_validate_runlog
from repro.obs import validate_trace as j_validate_trace
from repro_torch import sched
from repro_torch.configs import get_config
from repro_torch.configs.base import IDKDConfig, TrainConfig
from repro_torch.core.mixing import consensus_distance
from repro_torch.launch.train import run_training
from repro_torch.obs import (EVENT_SCHEMA, RunLog, Telemetry, TraceRecorder,
                             check, log, metrics, read_events,
                             start_torch_profiler, stop_torch_profiler,
                             validate_runlog, validate_trace)
from repro_torch.resil import GuardSpec, Resilience

torch.set_num_threads(1)


def test_schema_and_runlog_match_reference(tmp_path):
    assert EVENT_SCHEMA == J_SCHEMA
    rl = RunLog(tmp_path / "run.jsonl")
    rl.emit("schedule", segments=3, steps=12)
    rl.emit("metrics", step=4, loss=[1.0, np.float32(2.0)],
            consensus=torch.ones(2))
    rl.emit("health", step=5, tripped=np.array([True, False]))
    with pytest.raises(ValueError, match="unknown"):
        rl.emit("bogus")
    with pytest.raises(ValueError, match="missing"):
        rl.emit("segment", index=0)
    rl.close()
    assert validate_runlog(tmp_path / "run.jsonl") == \
        j_validate_runlog(tmp_path / "run.jsonl")
    assert read_events(tmp_path / "run.jsonl", "health")[0]["tripped"] == \
        [True, False]
    (tmp_path / "bad.jsonl").write_text('{"ev": "segment", "t": 0}\n')
    for validate in (validate_runlog, j_validate_runlog):
        with pytest.raises(ValueError, match="missing"):
            validate(tmp_path / "bad.jsonl")


def test_trace_and_check_cli_match_reference(tmp_path, capsys):
    tr = TraceRecorder()
    with tr.span("segment", cat="train", start=0, stop=3,
                 active=np.ones(2, bool)):
        pass
    tr.export(tmp_path / "trace.json")
    assert validate_trace(tmp_path / "trace.json") == \
        j_validate_trace(tmp_path / "trace.json") == 1
    assert check.main([str(tmp_path)]) == 1            # no run.jsonl yet
    with Telemetry(tmp_path, trace=True, meta={"arch": "x"}) as tel:
        tel.event("segment", index=0, start=0, stop=3)
        with tel.span("eval", cat="eval"):
            pass
    assert check.main([str(tmp_path), "--require-trace"]) == 0
    assert jcheck.main([str(tmp_path), "--require-trace"]) == 0
    (tmp_path / "trace.json").write_text('{"traceEvents": [{"ph": "X"}]}')
    assert check.main([str(tmp_path)]) == 1
    capsys.readouterr()


def test_log_is_quiet_under_pytest_and_settable():
    logger = log.get_logger()
    stream = io.StringIO()
    handler = logging.StreamHandler(stream)
    handler.setFormatter(logger.handlers[0].formatter)
    logger.addHandler(handler)
    try:
        assert not log.enabled(logging.INFO)
        log.info("hidden", step=1)
        log.set_level("DEBUG")
        log.debug("shown", x=1.23456, name="a b")
    finally:
        log.set_level("WARNING")
        logger.removeHandler(handler)
    assert "hidden" not in stream.getvalue()
    assert "[repro_torch D] shown x=1.235 name='a b'" in stream.getvalue()


def test_torch_profiler_hand_off(tmp_path):
    assert start_torch_profiler(tmp_path)
    torch.ones(3).sum()
    stop_torch_profiler()
    assert (tmp_path / "torch_trace.json").exists()
    stop_torch_profiler()                      # a second stop is a no-op


def test_metrics_match_reference_and_consensus_distance():
    rng = np.random.default_rng(0)
    n = 4
    jm, tm = jmetrics.init_node_metrics(n), metrics.init_node_metrics(n)
    for _ in range(3):
        params = {"a": rng.normal(size=(n, 3, 2)).astype(np.float32),
                  "b": rng.normal(size=(n, 5)).astype(np.float32)}
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        losses = rng.random(n).astype(np.float32)
        jm = jmetrics.update(jm, jnp.asarray(losses),
                             jax.tree.map(jnp.asarray, grads),
                             jax.tree.map(jnp.asarray, params))
        tparams = {k: torch.as_tensor(v) for k, v in params.items()}
        tm = metrics.update(tm, torch.as_tensor(losses),
                            {k: torch.as_tensor(v) for k, v in
                             grads.items()}, tparams)
    a, b = metrics.summarize(tm), jmetrics.summarize(jm)
    assert sorted(a) == sorted(b) and a["accum_steps"] == b["accum_steps"]
    for k in ("loss", "grad_norm", "consensus", "consensus_total",
              "ef_residual"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        float(torch.sqrt(tm["consensus_sq"].double().sum())),
        float(consensus_distance(tparams)), rtol=1e-6)
    assert metrics.summarize(metrics.reset(tm))["accum_steps"] == 0


def test_lm_training_telemetry_and_guard_are_observers(tmp_path):
    cfg = get_config("qwen1.5-0.5b").reduced().replace(
        num_layers=1, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, dtype="float32")
    tcfg = TrainConfig(num_nodes=2, steps=6, lr=0.1, alpha=0.1, batch_size=2,
                       idkd=IDKDConfig(start_step=3, label_topk=4,
                                       kd_weight=0.3,
                                       label_backend="sparse"))
    kw = dict(seq_len=16, n_seqs=16, n_public=4, use_idkd=True, log_every=2,
              verbose=False, device="cpu")
    base = run_training(cfg, tcfg, **kw)
    tel = Telemetry(tmp_path, trace=True)
    on = run_training(cfg, tcfg, telemetry=tel,
                      resil=Resilience(guard=GuardSpec()), **kw)
    tel.close()
    assert on["loss_history"] == base["loss_history"]
    for k, v in base["params"].items():
        assert torch.equal(on["params"][k], v), k
    assert jcheck.main([str(tmp_path), "--require-trace"]) == 0
    labels = read_events(tmp_path / "run.jsonl", "labels")
    assert len(labels) == 1 and "topk_overlap" in labels[0]
    assert len(read_events(tmp_path / "run.jsonl", "metrics")) == \
        len(read_events(tmp_path / "run.jsonl", "segment"))
    with pytest.raises(NotImplementedError, match="item 12"):
        run_training(cfg, dataclasses.replace(tcfg, steps=4),
                     events=[sched.ChurnEvent(1, down=(0,), mode="stale")],
                     **kw)
