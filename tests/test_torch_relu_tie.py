"""``chip_smoke.py``'s card-vs-CPU check of the ResNet algorithms, on the
CPU: a ReLU input within f32 rounding of 0 may take either branch in two
runs that sum their convolutions in another order, and one such element
passes its whole gradient or none. Here a stand-in for the card sends
every ReLU input within 1e-6 of 0 to the other branch: centralized SGD's
3 steps at the grid's lr (ResNet-8, 4 nodes, the phase's data and draws)
then end more than ``TRAIN_PARAM_ATOL`` from the plain CPU run, and
``_relu_replay`` of its branches brings the CPU run back onto it. A
replay refuses a flip farther from 0 than ``RELU_TIE`` of the call's
scale. The same holds
for a top-k payload (``_topk_replay``): a near-tie taken otherwise is
followed, any other difference refused; and the 3-step check of a
compressed run (``_gossip_steps_card_vs_cpu``) on one device agrees
exactly.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.resnet20_cifar import SMALL_CONFIG
from repro_torch.core.simulator import DecentralizedSimulator
from repro_torch.data.synthetic import make_classification_data
from repro_torch.mainpath import grid_config

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture(scope="module")
def setup():
    data = make_classification_data(image_size=32, n_train=256, n_val=32,
                                    n_test=64, noise=1.6, seed=0)
    tcfg, _ = grid_config("sgd-centralized", steps=3)
    return data, dataclasses.replace(tcfg, num_nodes=4, batch_size=8)


def _run(setup, relu=None):
    data, tcfg = setup
    with cs._same_draws(torch, 7), (relu or cs._Patch()):
        return DecentralizedSimulator(
            SMALL_CONFIG, tcfg, data, eval_every=100, eval_batches=1,
            device="cpu").run().params


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _flipped_relu(band, masks):
    """A ReLU that sends every input within ``band`` of 0 to the other
    branch and records the branches it took."""
    def relu(x, inplace=False):
        m = (x > 0) ^ (x.abs() < band)
        masks.append(m.clone())
        return torch.where(m, x, torch.zeros((), dtype=x.dtype))
    return cs._Patch((F, "relu", relu))


@pytest.fixture(scope="module")
def recorded(setup):
    """The plain CPU run, its ReLU branches recorded."""
    masks = []
    return _run(setup, cs._relu_record(masks)), masks


def test_relu_record_and_replay_on_one_device(setup, recorded):
    params, masks = recorded
    flips = []
    replayed = _run(setup, cs._relu_replay(torch, masks, flips))
    assert len(flips) == len(masks) > 0
    assert sum(flips) == 0
    assert _max_diff(params, replayed) == 0.0


def test_relu_tie_replay_follows_the_other_rounding(setup, recorded):
    masks, flips = [], []
    other = _run(setup, _flipped_relu(1e-6, masks))
    replayed = _run(setup, cs._relu_replay(torch, masks, flips))
    assert _max_diff(other, recorded[0]) > cs.TRAIN_PARAM_ATOL
    assert len(flips) == len(masks) and sum(flips) > 0
    assert _max_diff(other, replayed) <= 1e-7


def test_relu_replay_refuses_a_flip_beyond_the_tie_band(setup):
    masks = []
    _run(setup, _flipped_relu(1e-3, masks))
    with pytest.raises(SystemExit):
        _run(setup, cs._relu_replay(torch, masks, []))


@pytest.mark.parametrize("tape, calls", [
    # row 0 swaps a near-tie (3 + 1e-6 against 3), row 1 is the CPU's
    ([[[0, 1], [0, 1]]], [(2, 1)]),
    # one recorded entry serves two calls of a row each
    ([[[0, 2], [0, 1]]], [(1, 0), (1, 0)]),
    # a value 0.4 (relative) above one taken is left out
    ([[[0, 3], [0, 1]]], None),
])
def test_topk_replay_takes_near_ties_only(tape, calls):
    from repro_torch.core import mixing
    a = torch.tensor([[5.0, 3.0, 3.0 + 1e-6, 1.0], [4.0, 2.0, 1.0, 0.5]])
    tape = [torch.tensor(t) for t in tape]
    got = []
    with cs._topk_replay(torch, tape, got):
        if calls is None:
            with pytest.raises(SystemExit):
                mixing.topk_indices(a, 2)
            return
        idx = [mixing.topk_indices(r, 2)
               for r in ((a,) if len(calls) == 1 else (a[:1], a[1:]))]
    assert got == calls
    assert torch.equal(torch.cat(idx), tape[0])


@pytest.mark.parametrize("comp, gossip, key", [
    (("topk", 0.05), "delayed", "hat"),
    (("randk", 0.05), "sync", "hat"),
])
def test_gossip_steps_check_on_one_device(setup, comp, gossip, key):
    data, _ = setup
    tcfg, _ = grid_config("qg-dsgdm-n", steps=8)
    tcfg = dataclasses.replace(tcfg, num_nodes=4, batch_size=8,
                               compression=comp[0],
                               compression_frac=comp[1], gossip=gossip)
    sim = DecentralizedSimulator(SMALL_CONFIG, tcfg, data, eval_every=4,
                                 eval_batches=1, device="cpu")
    cap = sim.run(capture_at=5).captured
    real = cs._run_steps

    def on_cpu(torch, sim, step, cap, device, t0, patches):
        return real(torch, sim, step, cap, "cpu", t0, patches)
    with cs._Patch((cs, "_run_steps", on_cpu)):
        dp, dh, taken, flips = cs._gossip_steps_card_vs_cpu(torch, sim, cap,
                                                            key)
    assert (dp, dh, taken, flips) == (0.0, 0.0, 0, 0)
