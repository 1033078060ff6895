"""The slice end to end: the port's simulator against the reference's on
the same data, partition and initial weights (replayed — the port's own
init draws other numbers), through one streaming IDKD round on the
sparse backend. The samplers draw different batches on the two sides,
so the runs are held to a band, not to float tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import IDKDConfig as JIDKD
from repro.configs.base import TrainConfig as JTrain
from repro.configs.resnet20_cifar import SMALL_CONFIG as J_SMALL
from repro.core.idkd import skew_metric as j_skew
from repro.core.simulator import DecentralizedSimulator as JSim
from repro.data.synthetic import make_classification_data, make_public_data
from repro_torch.configs.base import IDKDConfig as TIDKD
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.resnet20_cifar import SMALL_CONFIG as T_SMALL
from repro_torch.core.idkd import skew_metric as t_skew
from repro_torch.core.simulator import DecentralizedSimulator as TSim
from repro_torch.models.convert import from_jax_params

from test_torch_common import resnet_tree

torch.set_num_threads(1)

# bands around the reference's result (stated, not fitted to one run:
# each is about a third of the quantity's range in a 40-step run)
ACC_BAND, KEPT_BAND, SKEW_BAND = 0.15, 0.15, 0.1


def test_simulator_matches_reference_band():
    data = make_classification_data(image_size=8, n_train=512, n_val=64,
                                    n_test=256, noise=1.6, seed=0)
    pub = make_public_data(data, n_public=256, kind="aligned", seed=1)
    kw = dict(algorithm="qg-dsgdm-n", num_nodes=4, alpha=0.05, steps=40,
              batch_size=16, lr=0.5)
    icfg = dict(start_step=28, temperature=10.0, label_backend="sparse")
    tree = resnet_tree(J_SMALL.replace(image_size=8), seed=0)

    jsim = JSim(J_SMALL.replace(image_size=8),
                JTrain(idkd=JIDKD(**icfg), **kw), data, pub, kd_mode="idkd",
                eval_every=20)
    jsim.model.init = lambda key: jax.tree.map(jnp.asarray, tree)
    ref = jsim.run()

    tsim = TSim(T_SMALL.replace(image_size=8),
                TTrain(idkd=TIDKD(**icfg), **kw), data, pub, kd_mode="idkd",
                eval_every=20, device="cpu")
    tsim.model.init = lambda gen: from_jax_params(tree, device="cpu")
    out = tsim.run()

    np.testing.assert_array_equal(out.pre_hist, ref.pre_hist)
    assert len(out.acc_history) == len(ref.acc_history) == 3
    # step 0 is evaluated after one step from identical weights
    assert abs(out.acc_history[0] - ref.acc_history[0]) <= ACC_BAND
    assert abs(out.final_acc - ref.final_acc) <= ACC_BAND
    assert 0.0 < out.id_fraction < 1.0
    assert abs(out.id_fraction - ref.id_fraction) <= KEPT_BAND
    pre = t_skew(out.pre_hist)
    j_post = float(j_skew(jnp.asarray(ref.post_hist)))
    assert t_skew(out.post_hist) < pre and j_post < pre
    assert abs(t_skew(out.post_hist) - j_post) <= SKEW_BAND
    assert np.isfinite(out.loss_history).all()
    assert out.comm_bytes_per_iter == ref.comm_bytes_per_iter
    assert [r["step"] for r in out.rounds] == [r["step"] for r in ref.rounds]
