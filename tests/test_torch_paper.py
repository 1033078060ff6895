"""The paper's experiment harness (``repro_torch.paper``) against the
reference's (``benchmarks/``), on the CPU, without compiling the JAX
simulator:

(a) each table module, fed the same canned cells, gives the reference's
    rows, CSV names and derived strings, rendering, and Figure 3 skews;
(b) ``run_cell`` at the ``"reference"`` setting builds the reference's
    simulator: every config field, the data and public arrays bitwise,
    kd_mode, the eval cadence, the result keys;
(c) one real run of the port's ``run_cell`` on the CPU, round-tripped
    through its JSON cache.
"""
import dataclasses
import json
import os
import types
import zlib

import numpy as np
import pytest

from benchmarks import common as jcommon
from benchmarks import (fig3_homogenize as jfig3, table2_noniid as jt2,
                        table3_topology as jt3, table4_public as jt4,
                        table6_comm as jt6, table7_scale as jt7)
from repro.core.idkd import skew_metric as jskew
from repro_torch import mainpath
from repro_torch.core.idkd import skew_metric as tskew
from repro_torch.paper import __main__ as tmain
from repro_torch.paper import common as tcommon
from repro_torch.paper import (fig3_homogenize as tfig3, lr_sweep,
                               table2_noniid as tt2, table3_topology as tt3,
                               table4_public as tt4, table6_comm as tt6,
                               table7_scale as tt7)

TABLES = [(jt2, tt2), (jt3, tt3), (jt4, tt4), (jt6, tt6), (jt7, tt7)]


def canned_cell(method, alpha, nodes=8, topology="ring",
                public_kind="aligned", seed=4, steps=None, use_cache=True,
                **_):
    """A deterministic result dict made from a numpy seed that hashes the
    cell's arguments."""
    rng = np.random.default_rng(zlib.crc32(
        f"{method}|{alpha}|{nodes}|{topology}|{public_kind}|{seed}".encode()))
    steps = steps or 300
    pre = rng.dirichlet(np.full(10, alpha), size=nodes)
    post = 0.5 * pre + 0.5 * rng.dirichlet(np.ones(10), size=nodes)
    post[0, :3] = 0.0
    return {"method": method, "alpha": alpha, "nodes": nodes,
            "topology": topology, "public_kind": public_kind, "seed": seed,
            "steps": steps, "final_acc": float(rng.random()),
            "acc_history": rng.random(5).tolist(),
            "loss_history": rng.random(5).tolist(),
            "consensus_history": rng.random(5).tolist(),
            "id_fraction": float(rng.random()),
            "comm_bytes_per_iter": float(rng.integers(1e5, 1e7)),
            "label_bytes_total": float(rng.integers(1e4, 1e6)),
            "pre_hist": pre.tolist(), "post_hist": post.tolist(),
            "wall_seconds": float(rng.random())}


@pytest.fixture
def canned(monkeypatch):
    for jmod, tmod in TABLES + [(jfig3, tfig3)]:
        monkeypatch.setattr(jmod, "run_cell", canned_cell)
        monkeypatch.setattr(tmod, "run_cell", canned_cell)


# ------------------------------------------------------------ (a) tables
@pytest.mark.parametrize("pair", TABLES, ids=lambda p: p[0].__name__)
@pytest.mark.parametrize("setting", ["reference", "full"])
def test_tables_match_reference(canned, pair, setting):
    jmod, tmod = pair
    jrows, jcsv = jmod.run()
    trows, tcsv = tmod.run(setting=setting, device="cpu")
    assert trows == jrows
    assert [(n, d) for n, _, d in tcsv] == [(n, d) for n, _, d in jcsv]
    assert tmod.render(trows) == jmod.render(jrows)
    for name in ("METHODS", "ALPHAS", "GRID", "KINDS", "NODES"):
        assert getattr(tmod, name, None) == getattr(jmod, name, None)


def test_fig3_matches_reference(canned):
    jrows, jcsv, jcurves = jfig3.run()
    trows, tcsv, tcurves = tfig3.run(setting="full", device="cpu")
    assert trows == jrows
    assert [(n, d) for n, _, d in tcsv] == [(n, d) for n, _, d in jcsv]
    assert tcurves == jcurves
    cell = canned_cell("qg-idkd", 0.1)
    for key in ("pre_hist", "post_hist"):
        h = np.asarray(cell[key])
        np.testing.assert_allclose(tskew(h), float(jskew(h)), atol=1e-6)


def test_cli_prints_the_sections(canned, capsys):
    tmain.main(["--only", "table6,fig3", "--setting", "reference",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("name,us_per_call,derived\n")
    assert "table6/overhead_pct,0.0," in out
    assert "\n## table6\n" + tt6.render(tt6.run()[0]) in out
    assert "fig3a/skew_pre,0.0," in out and "# fig3 done in" in out


def test_cli_reports_a_failed_section(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("cell failed")
    monkeypatch.setattr(tt7, "run_cell", broken)
    monkeypatch.setattr(tt6, "run_cell", canned_cell)
    with pytest.raises(SystemExit, match="table7"):
        tmain.main(["--only", "table7,table6", "--device", "cpu"])
    assert "## table6" in capsys.readouterr().out


# --------------------------------------------------------- (b) run_cell
class _Recorder:
    """Stands in for the simulator: records what it was built with and
    returns a canned result."""
    calls = []

    def __init__(self, mcfg, tcfg, data, public_x=None, kd_mode=None,
                 eval_every=50, eval_batches=4, **kw):
        self.calls.append(dict(mcfg=mcfg, tcfg=tcfg, data=data,
                               public_x=public_x, kd_mode=kd_mode,
                               eval_every=eval_every,
                               eval_batches=eval_batches, kw=kw))

    def run(self):
        c = canned_cell("x", 0.1)
        return types.SimpleNamespace(
            final_acc=c["final_acc"], acc_history=c["acc_history"],
            loss_history=c["loss_history"],
            consensus_history=c["consensus_history"],
            id_fraction=c["id_fraction"],
            comm_bytes_per_iter=c["comm_bytes_per_iter"],
            label_bytes_total=c["label_bytes_total"],
            pre_hist=np.asarray(c["pre_hist"]),
            post_hist=np.asarray(c["post_hist"]),
            wall_seconds=c["wall_seconds"])


CELLS = [("dsgd", 1.0, 8, "ring", "aligned"),
         ("relay-sgd", 0.1, 8, "ring", "aligned"),
         ("qg-dsgdm-n", 0.05, 15, "social", "aligned"),
         ("qg-dsgdm-n+kd", 0.05, 8, "ring", "shifted"),
         ("qg-idkd", 0.1, 16, "ring", "noise"),
         ("sgd-centralized", 0.1, 8, "ring", "aligned")]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_run_cell_reference_setting_builds_the_reference_run(monkeypatch,
                                                             tmp_path, cell):
    assert set(tcommon._METHODS) == {c[0] for c in CELLS}
    method, alpha, nodes, topo, kind = cell
    runs = {}
    for side, mod in (("jax", jcommon), ("torch", tcommon)):
        rec = type("Rec", (_Recorder,), {"calls": []})
        monkeypatch.setattr(mod, "DecentralizedSimulator", rec)
        monkeypatch.setattr(mod, "CACHE_DIR", str(tmp_path / side))
        kw = {} if side == "jax" else dict(setting="reference",
                                           device="cpu")
        out = mod.run_cell(method, alpha, nodes, topo, kind, seed=34,
                           steps=40, use_cache=False, **kw)
        assert len(rec.calls) == 1
        runs[side] = (rec.calls[0], out)
    (j, jout), (t, tout) = runs["jax"], runs["torch"]
    assert dataclasses.asdict(t["tcfg"]) == dataclasses.asdict(j["tcfg"])
    assert dataclasses.asdict(t["mcfg"]) == dataclasses.asdict(j["mcfg"])
    for key in ("kd_mode", "eval_every", "eval_batches"):
        assert t[key] == j[key]
    for f in dataclasses.fields(j["data"]):
        np.testing.assert_array_equal(getattr(t["data"], f.name),
                                      getattr(j["data"], f.name))
    if j["public_x"] is None:
        assert t["public_x"] is None
    else:
        assert t["public_x"].dtype == j["public_x"].dtype
        np.testing.assert_array_equal(t["public_x"], j["public_x"])
    assert t["kw"] == {"device": "cpu"}
    assert list(tout) == list(jout) and tout == jout


def test_full_setting_and_lr_rule():
    """The "full" setting is the main path's width, and GRID reads the
    same lr table."""
    s = tcommon.SETTINGS["full"]
    assert s.model == mainpath.CONFIG and s.batch == 32
    assert (s.idkd.label_backend, s.idkd.stream_labels,
            s.idkd.temperature) == ("sparse", True, 10.0)
    for method, (algorithm, kd_mode) in tcommon._METHODS.items():
        assert mainpath.METHODS[method] == (algorithm, kd_mode)
        tcfg, _ = mainpath.grid_config(method)
        assert tcfg.lr == tcommon.FULL_WIDTH_LR[method]
        assert tcfg.weight_decay == tcommon.harness_rule(algorithm)[1]
        assert tcommon.cell_lr(method, "reference") == \
            tcommon.harness_rule(algorithm)
    for method in ("d2", "gradient-tracking"):
        assert mainpath.grid_config(method)[0].lr == 0.1
    rule = tcommon.harness_rule("centralized")[0]
    assert lr_sweep.pick("sgd-centralized",
                         {0.5: 2.0, 0.1: 1.96, 0.05: 1.97}) == rule
    assert lr_sweep.pick("sgd-centralized",
                         {0.5: 2.3, 0.1: 1.7, 0.05: 1.5}) == 0.05
    assert lr_sweep.pick("dsgd", {0.5: float("nan"), 0.2: 0.56,
                                  0.1: 0.76, 0.05: 1.1}) == 0.2
    assert lr_sweep.pick("dsgd", {0.5: float("nan"), 0.1: 0.76}) == 0.1


# ------------------------------------------------------- (c) a real run
def test_run_cell_real_run_round_trips_through_the_cache(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(tcommon, "CACHE_DIR", str(tmp_path))
    out = tcommon.run_cell("qg-idkd", 0.1, nodes=2, steps=4,
                           setting="reference", device="cpu")
    assert out["steps"] == 4 and len(out["loss_history"]) == 4
    assert np.all(np.isfinite(out["loss_history"]))
    assert 0.0 < out["id_fraction"] <= 1.0 and out["label_bytes_total"] > 0
    assert json.loads(json.dumps(out)) == out
    files = os.listdir(tmp_path)
    assert files == ["qg-idkd_a0.1_n2_ring_aligned_s4_t4_reference_cpu.json"]

    def refuse(*a, **k):
        raise AssertionError("served from the cache, nothing runs")
    monkeypatch.setattr(tcommon, "DecentralizedSimulator", refuse)
    again = tcommon.run_cell("qg-idkd", 0.1, nodes=2, steps=4,
                             setting="reference", device="cpu")
    assert again == out
