"""The learners' networks: `pvderx_torch.learn.nets` against
`pvderx.learn.nets`.

- Forward: each of the four nets, with the same float32 parameters (made
  with numpy from a seed, biases nonzero, carried into torch by
  `pvderx_torch.convert`), equals Flax's ``net.apply`` on the same inputs:
  <= 1e-12 in float64 compute (the sums differ only in order) and <= 1e-6
  in float32 compute (float32 roundoff of the matmuls, ~1e-7 at these
  widths).
- Init: orthogonal weights (the smaller Gram matrix of each weight is
  gain² I, gains √2 / 0.01 / 1) and zero biases, parameters float32 for
  every compute dtype, the init drawn from the caller's generator alone
  and made on its device.
- Gradients reach the float32 parameters as float32 under float64 compute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.learn import nets as jnets
from pvderx_torch import convert
from pvderx_torch.learn import nets

OBS, ACT, HIDDEN = 13, 2, (32, 24)

_JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _flax_params(net, rng, *inputs):
    """Flax's param tree of ``net`` with every leaf replaced by seeded
    numpy float32 draws (nonzero biases)."""
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), *inputs))
    return jax.tree.map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _port(make, params, dtype):
    net = make(dtype=dtype, generator=torch.Generator().manual_seed(0))
    net.load_state_dict(convert.flax_state_dict(net, params))
    return net


def _close(got, want, dtype):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.dtype(str(dtype).split(".")[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_learn_nets_forward_matches_flax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((17, OBS))
    a = np.tanh(rng.standard_normal((17, ACT)))
    xj = jnp.asarray(x, _JDT[dtype])
    xt = torch.tensor(x, dtype=dtype)
    jdt = _JDT[dtype]

    jnet = jnets.ActorCritic(n_actions=6, hidden=HIDDEN, dtype=jdt)
    p = _flax_params(jnet, rng, xj)
    net = _port(lambda **k: nets.ActorCritic(OBS, 6, HIDDEN, **k), p, dtype)
    (lj, vj), (lt, vt) = jnet.apply(p, xj), net(xt)
    _close(lt, lj, dtype)
    _close(vt, vj, dtype)

    jnet = jnets.QNetwork(n_actions=5, hidden=HIDDEN, dtype=jdt)
    p = _flax_params(jnet, rng, xj)
    net = _port(lambda **k: nets.QNetwork(OBS, 5, HIDDEN, **k), p, dtype)
    _close(net(xt), jnet.apply(p, xj), dtype)

    # log_std wide enough that both clip bounds bite
    jnet = jnets.TanhGaussianActor(act_dim=ACT, hidden=HIDDEN, dtype=jdt)
    p = _flax_params(jnet, rng, xj)
    p["params"]["Dense_3"]["bias"] = np.array([-6.0, 2.5], np.float32)
    net = _port(lambda **k: nets.TanhGaussianActor(OBS, ACT, HIDDEN, **k), p, dtype)
    (mj, sj), (mt, st) = jnet.apply(p, xj), net(xt)
    _close(mt, mj, dtype)
    _close(st, sj, dtype)
    assert float(st.detach().min()) == nets.LOG_STD_MIN
    assert float(st.detach().max()) == nets.LOG_STD_MAX

    aj = jnp.asarray(a, jdt)
    jnet = jnets.DoubleCritic(hidden=HIDDEN, dtype=jdt)
    p = _flax_params(jnet, rng, xj, aj)
    net = _port(lambda **k: nets.DoubleCritic(OBS, ACT, HIDDEN, **k), p, dtype)
    (q1j, q2j) = jnet.apply(p, xj, aj)
    (q1t, q2t) = net(xt, torch.tensor(a, dtype=dtype))
    _close(q1t, q1j, dtype)
    _close(q2t, q2j, dtype)
    assert not np.allclose(np.asarray(q1j), np.asarray(q2j))


def _gains(net):
    hid = np.sqrt(2.0)
    if isinstance(net, nets.ActorCritic):
        return [hid] * len(net.trunk) + [0.01, 1.0]
    if isinstance(net, nets.QNetwork):
        return [hid] * len(net.trunk) + [1.0]
    if isinstance(net, nets.TanhGaussianActor):
        return [hid] * len(net.trunk) + [0.01, 0.01]
    return ([hid] * (len(net.q1) - 1) + [1.0]) * 2


@pytest.mark.parametrize("make", [
    lambda **k: nets.ActorCritic(OBS, 6, HIDDEN, **k),
    lambda **k: nets.QNetwork(OBS, 5, HIDDEN, **k),
    lambda **k: nets.TanhGaussianActor(OBS, ACT, HIDDEN, **k),
    lambda **k: nets.DoubleCritic(OBS, ACT, HIDDEN, **k),
], ids=["actor_critic", "qnetwork", "tanh_gaussian", "double_critic"])
def test_torch_learn_nets_init_is_orthogonal_with_zero_bias(make):
    state = torch.random.get_rng_state()
    g = torch.Generator().manual_seed(3)
    net = make(dtype=torch.float64, generator=g)
    # the init draws from the given generator only, on its device
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(p.device == g.device for p in net.parameters())
    layers = net.layers()
    assert len(layers) == len(_gains(net))
    for lin, gain in zip(layers, _gains(net)):
        w = lin.weight.detach().double()
        assert lin.weight.dtype == lin.bias.dtype == torch.float32
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        np.testing.assert_allclose(gram.numpy(), gain ** 2 * np.eye(len(gram)),
                                   rtol=0, atol=1e-6 * gain ** 2)
        assert not lin.bias.any()
    again = make(dtype=torch.float64,
                 generator=torch.Generator().manual_seed(3))
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_torch_learn_nets_float32_params_under_float64_compute():
    net = nets.ActorCritic(OBS, 5, HIDDEN, torch.float64,
                           generator=torch.Generator().manual_seed(1))
    x = torch.randn(8, OBS, generator=torch.Generator().manual_seed(2))
    logits, v = net(x)
    assert logits.dtype == v.dtype == torch.float64
    (logits.sum() + v.sum()).backward()
    for p in net.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all()


def test_torch_learn_nets_flax_state_dict_checks_the_layer_count():
    rng = np.random.default_rng(4)
    jnet = jnets.QNetwork(n_actions=5, hidden=HIDDEN)
    p = _flax_params(jnet, rng, jnp.zeros((1, OBS)))
    net = nets.ActorCritic(OBS, 5, HIDDEN,
                           generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="3 Dense layers for 4 Linear"):
        convert.flax_state_dict(net, p)
