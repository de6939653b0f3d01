"""Policy export: `pvderx_torch.learn.export` against the torch forward and
against `pvderx.learn.export`.

- Each exported policy (PPO's ActorCritic, DQN's QNetwork, SAC's
  TanhGaussianActor) reproduces the float32 torch forward to float32
  roundoff (<= 1e-5 absolute at these widths, the reference's own export
  tolerance), and its greedy action.
- The JSON artifact is the reference's format both ways: the reference's
  `NumpyMLPPolicy.from_json` reads the port's JSON to the same outputs bit
  for bit, and the port reads the reference's export of the same weights
  (carried over as Flax params by `pvderx_torch.convert`) to the same
  arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.learn import export as jexport
from pvderx.learn import nets as jnets
from pvderx_torch import convert
from pvderx_torch.learn import export, nets

OBS = 13


def _obs(seed, n=32):
    return np.random.default_rng(seed).standard_normal((n, OBS)).astype(
        np.float32)


CASES = {
    "actor_critic": (lambda g: nets.ActorCritic(OBS, 5, generator=g),
                     export.export_actor_critic, jexport.export_actor_critic,
                     lambda: jnets.ActorCritic(n_actions=5)),
    "qnetwork": (lambda g: nets.QNetwork(OBS, 6, generator=g),
                 export.export_qnetwork, jexport.export_qnetwork,
                 lambda: jnets.QNetwork(n_actions=6)),
    "tanh_gaussian": (lambda g: nets.TanhGaussianActor(OBS, 2, generator=g),
                      export.export_tanh_gaussian,
                      jexport.export_tanh_gaussian,
                      lambda: jnets.TanhGaussianActor(act_dim=2)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_torch_learn_export_matches_torch_forward(name):
    make, exp, *_ = CASES[name]
    net = make(torch.Generator().manual_seed(1))
    with torch.no_grad():     # nonzero biases, so their export is checked
        for lin in net.layers():
            lin.bias.normal_(0.0, 0.1, generator=torch.Generator())
    pol = exp(net)
    obs = _obs(2)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    if name == "actor_critic":
        logits, value = (o.numpy() for o in out)
        np.testing.assert_allclose(pol.head("logits", obs), logits, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(pol.head("value", obs)[:, 0], value,
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(pol.act(obs), np.argmax(logits, -1))
    elif name == "qnetwork":
        q = out.numpy()
        np.testing.assert_allclose(pol.head("q", obs), q, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(pol.act(obs), np.argmax(q, -1))
    else:
        mu = out[0].numpy()
        np.testing.assert_allclose(pol.act(obs), np.tanh(mu), rtol=0,
                                   atol=1e-5)
    # the reference reads the port's artifact to the same outputs
    ref = jexport.NumpyMLPPolicy.from_json(pol.to_json())
    back = export.NumpyMLPPolicy.from_json(pol.to_json())
    assert ref.activation == pol.activation
    for p in (ref, back):
        for head in pol.heads:
            np.testing.assert_array_equal(p.head(head, obs),
                                          pol.head(head, obs))
        np.testing.assert_array_equal(p.act(obs), pol.act(obs))


@pytest.mark.parametrize("name", list(CASES))
def test_torch_learn_export_reads_the_references_artifact(name):
    make, exp, jexp, jmake = CASES[name]
    params = jmake().init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)))
    jpol = jexp(params)
    net = make(torch.Generator())
    net.load_state_dict(
        convert.flax_state_dict(net, jax.tree.map(np.asarray, params)))
    pol = exp(net)
    got = export.NumpyMLPPolicy.from_json(jpol.to_json())
    for (k1, b1), (k2, b2) in zip(got.trunk, pol.trunk):
        assert np.array_equal(k1, k2) and np.array_equal(b1, b2)
    assert set(got.heads) == set(pol.heads)
    for head in pol.heads:
        for a, b in zip(got.heads[head], pol.heads[head]):
            assert np.array_equal(a, b)
    obs = _obs(4)
    np.testing.assert_array_equal(got.act(obs), jpol.act(obs))
