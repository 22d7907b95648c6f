"""Networks of the PyTorch port against the JAX package's: flax params
carried across with `pearl_tpu_torch.utils.jax_params` give the same `q_all`
for `MultiHeadQValueNetwork` and `VanillaQValueNetwork`, the same actions,
samples (on the same normal draws) and log-probabilities for the continuous
actors, and the same `q_both`/`q_min` for `TwinCritic`; the inits and
`select_index_last` follow the reference. The MLP's options (layer norm,
skip connections, another activation, lecun init, dropout), `ResidualWrapper`,
`over_actions` and the Q-networks' `use_layer_norm` give JAX's values and
gradients, and an MLP with options never reaches `ops.fused_mlp`.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.neural_networks.actor_networks import (
    GaussianActorNetwork as JaxGaussian,
    VanillaContinuousActorNetwork as JaxDeterministic,
)
import flax.linen as flax_nn

from pearl_tpu.neural_networks.common import MLP as JaxMLP
from pearl_tpu.neural_networks.common import ResidualWrapper as JaxResidualWrapper
from pearl_tpu.neural_networks.common import over_actions as jax_over_actions
from pearl_tpu.neural_networks.common import select_index_last as jax_select
from pearl_tpu.neural_networks.q_value_networks import (
    MultiHeadQValueNetwork as JaxMultiHead,
    QuantileQValueNetwork as JaxQuantile,
    VanillaQValueNetwork as JaxVanilla,
)
from pearl_tpu.neural_networks.twin_critic import TwinCritic as JaxTwin
from pearl_tpu_torch.neural_networks import (
    MLP,
    GaussianActorNetwork,
    MultiHeadQValueNetwork,
    QuantileQValueNetwork,
    TwinCritic,
    VanillaContinuousActorNetwork,
    VanillaQValueNetwork,
    select_index_last,
)
from pearl_tpu_torch.neural_networks.common import ResidualWrapper, dense, dropout, over_actions
from pearl_tpu_torch.ops.fused_mlp import fused_mlp_from_module
from pearl_tpu_torch.utils.jax_params import (
    load_flax_dense,
    load_flax_deterministic_actor_params,
    load_flax_gaussian_actor_params,
    load_flax_mlp,
    load_flax_q_params,
    load_flax_twin_critic_params,
)

torch.set_num_threads(1)

# float32 matmuls by XLA and by PyTorch on the CPU: the same products summed
# in another order; atol covers Q-values near zero.
Q_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _inputs(B=33, state_dim=4, num_actions=3, seed=0):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((B, state_dim)).astype(np.float32)
    cand = np.eye(num_actions, dtype=np.float32)  # one-hot candidates
    actions = np.broadcast_to(cand, (B, num_actions, num_actions)).copy()
    return state, actions


@pytest.mark.parametrize(
    "jax_net,net,hidden",
    [
        (JaxMultiHead, MultiHeadQValueNetwork, (64, 64)),
        (JaxMultiHead, MultiHeadQValueNetwork, (32, 16, 8)),
        (JaxVanilla, VanillaQValueNetwork, (64, 64)),
    ],
)
def test_q_all_with_carried_weights_matches_jax(jax_net, net, hidden):
    state, actions = _inputs()
    jnet = jax_net(hidden_dims=hidden)
    params = jnet.init(jax.random.PRNGKey(3), 4, 3, 3)
    ref = np.asarray(jnet.q_all(params, jnp.asarray(state), jnp.asarray(actions)))

    tnet = net(hidden_dims=hidden)
    module = tnet.init(torch.Generator().manual_seed(0), 4, 3, 3)
    load_flax_q_params(module, _np_tree(params))
    with torch.no_grad():
        q = tnet.q_all(module, torch.from_numpy(state), torch.from_numpy(actions)).numpy()
    assert q.shape == ref.shape == (33, 3)
    np.testing.assert_allclose(q, ref, **Q_TOL)


def test_weight_carry_transposes_kernels_and_checks_the_tree():
    params = JaxMultiHead().init(jax.random.PRNGKey(0), 4, 2, 2)
    module = MultiHeadQValueNetwork().init(torch.Generator().manual_seed(0), 4, 2, 2)
    load_flax_q_params(module, _np_tree(params))
    for name, layer in zip(module.MLP_0.layer_names, module.MLP_0.layers()):
        kernel = np.asarray(params["MLP_0"][name]["kernel"])
        np.testing.assert_array_equal(layer.weight.detach().numpy(), kernel.T)
        np.testing.assert_array_equal(
            layer.bias.detach().numpy(), np.asarray(params["MLP_0"][name]["bias"])
        )
    with pytest.raises(ValueError):  # layer-name mismatch
        load_flax_q_params(module, {"MLP_0": {"dense_0": params["MLP_0"]["dense_0"]}})
    wrong = MultiHeadQValueNetwork(hidden_dims=(32, 32)).init(None, 4, 2, 2)
    with pytest.raises(ValueError):  # shape mismatch
        load_flax_q_params(wrong, _np_tree(params))
    with pytest.raises(ValueError):  # not a Q-network tree
        load_flax_q_params(module, {"params": {}})


def test_mlp_init_is_xavier_uniform_with_zero_bias():
    global_rng = torch.get_rng_state()
    mlp = MLP(4, (64, 64), 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.get_rng_state(), global_rng)  # draws only from `generator`
    assert mlp.layer_names == ["dense_0", "dense_1", "dense_out"]
    for layer in mlp.layers():
        d_out, d_in = layer.weight.shape
        bound = np.sqrt(6.0 / (d_in + d_out))
        assert layer.weight.abs().max() <= bound
        assert layer.weight.abs().max() > 0.8 * bound  # spans the range
        assert (layer.bias == 0).all()
    again = MLP(4, (64, 64), 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(mlp.dense_0.weight, again.dense_0.weight, rtol=0, atol=0)


def test_select_index_last_matches_jax():
    rng = np.random.default_rng(4)
    values = rng.standard_normal((50, 5)).astype(np.float32)
    index = rng.integers(0, 5, 50).astype(np.int32)
    ours = select_index_last(torch.from_numpy(values), torch.from_numpy(index)).numpy()
    ref = np.asarray(jax_select(jnp.asarray(values), jnp.asarray(index)))
    np.testing.assert_array_equal(ours, ref)  # x*1 + 0*y is exact
    np.testing.assert_array_equal(ours, values[np.arange(50), index])


# The continuous-control networks: tanh, exp and log of XLA and PyTorch may
# differ by an ulp on top of the summation order.
AC_TOL = dict(rtol=1e-5, atol=1e-5)


def _continuous_inputs(B=40, state_dim=3, action_dim=2, seed=1):
    rng = np.random.default_rng(seed)
    state = rng.standard_normal((B, state_dim)).astype(np.float32)
    low = np.float32([-2.0, -0.5][:action_dim])
    high = np.float32([2.0, 1.5][:action_dim])
    action = rng.uniform(low, high, (B, action_dim)).astype(np.float32)
    action[0] = low  # at the box's edges: atanh of a clipped +-(1 - 1e-6)
    action[1] = high
    return state, action, low, high


@pytest.mark.parametrize("hidden", [(64, 64), (32, 16, 8)])
def test_gaussian_actor_matches_jax(hidden):
    state, action, low, high = _continuous_inputs()
    jnet, net = JaxGaussian(hidden_dims=hidden), GaussianActorNetwork(hidden_dims=hidden)
    params = jnet.init(jax.random.PRNGKey(2), 3, 2)
    module = net.init(torch.Generator().manual_seed(0), 3, 2)
    load_flax_gaussian_actor_params(module, _np_tree(params))
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.normal(key, (40, 2)))
    j = [jnp.asarray(x) for x in (state, action, low, high)]
    t = [torch.from_numpy(x) for x in (state, action, low, high)]
    ref_mu, ref_log_std = jnet._dist(params, j[0], 2)
    ref_a, ref_lp = jnet.sample_action(params, j[0], key, j[2], j[3])
    with torch.no_grad():
        mu, log_std = module(t[0])
        a, lp = net.sample_action(module, t[0], None, t[2], t[3], noise=torch.tensor(eps))
        mean = net.mean_action(module, t[0], t[2], t[3])
        glp = net.get_log_probability(module, t[0], t[1], t[2], t[3])
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), **AC_TOL)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(ref_log_std), **AC_TOL)
    assert (log_std >= -5.0).all() and (log_std <= 2.0).all()
    assert a.shape == (40, 2) and lp.shape == (40,)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), **AC_TOL)
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), **AC_TOL)
    np.testing.assert_allclose(
        mean.numpy(), np.asarray(jnet.mean_action(params, j[0], j[2], j[3])), **AC_TOL
    )
    ref_glp = np.asarray(jnet.get_log_probability(params, *j))
    np.testing.assert_allclose(glp.numpy()[2:], ref_glp[2:], **AC_TOL)
    # Rows 0 and 1 sit on the box's edges, where both packages clip to
    # +-(1 - 1e-6) and take atanh there (about 7.25): an ulp of that value
    # (5e-7) is multiplied by (pre_tanh - mu) / std^2 in the Gaussian term,
    # which reaches 1e3 here; rtol 1e-4 of the result.
    np.testing.assert_allclose(glp.numpy()[:2], ref_glp[:2], rtol=1e-4, atol=1e-5)
    # log pi of the sampled action recovered through atanh is the sample's.
    with torch.no_grad():
        again = net.get_log_probability(module, t[0], a, t[2], t[3])
    inner = (a - t[2]).abs().min(-1).values.gt(1e-3) & (t[3] - a).abs().min(-1).values.gt(1e-3)
    torch.testing.assert_close(again[inner], lp[inner], rtol=1e-3, atol=1e-3)


def test_gaussian_actor_sample_is_reparameterised_and_seeded():
    state, _, low, high = _continuous_inputs()
    net = GaussianActorNetwork()
    module = net.init(torch.Generator().manual_seed(0), 3, 2)
    a, lp = net.sample_action(
        module, torch.from_numpy(state), torch.Generator().manual_seed(4),
        torch.from_numpy(low), torch.from_numpy(high),
    )
    (lp.sum() + a.sum()).backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in module.parameters())
    again, _ = net.sample_action(
        module, torch.from_numpy(state), torch.Generator().manual_seed(4),
        torch.from_numpy(low), torch.from_numpy(high),
    )
    assert torch.equal(a, again)
    assert ((a >= torch.from_numpy(low)) & (a <= torch.from_numpy(high))).all()


def test_deterministic_actor_matches_jax():
    state, _, low, high = _continuous_inputs(action_dim=1)
    jnet, net = JaxDeterministic(), VanillaContinuousActorNetwork()
    params = jnet.init(jax.random.PRNGKey(3), 3, 1)
    module = net.init(torch.Generator().manual_seed(0), 3, 1)
    load_flax_deterministic_actor_params(module, _np_tree(params))
    ref = np.asarray(jnet.action(params, jnp.asarray(state), jnp.asarray(low), jnp.asarray(high)))
    with torch.no_grad():
        a = net.action(module, torch.from_numpy(state), torch.from_numpy(low), torch.from_numpy(high))
        s, lp = net.sample_action(
            module, torch.from_numpy(state), None, torch.from_numpy(low), torch.from_numpy(high)
        )
    np.testing.assert_allclose(a.numpy(), ref, **AC_TOL)
    assert torch.equal(s, a) and lp.shape == (40,) and (lp == 0).all()
    assert ((a >= -2.0) & (a <= 2.0)).all()


@pytest.mark.parametrize("hidden", [(64, 64), (16,)])
def test_twin_critic_matches_jax(hidden):
    state, action, _, _ = _continuous_inputs()
    jnet, net = JaxTwin(hidden_dims=hidden), TwinCritic(hidden_dims=hidden)
    params = jnet.init(jax.random.PRNGKey(4), 3, 2)
    module = net.init(torch.Generator().manual_seed(0), 3, 2)
    load_flax_twin_critic_params(module, _np_tree(params))
    js, ja = jnp.asarray(state), jnp.asarray(action)
    ref1, ref2 = jnet.q_both(params, js, ja)
    with torch.no_grad():
        q1, q2 = net.q_both(module, torch.from_numpy(state), torch.from_numpy(action))
        qmin = net.q_min(module, torch.from_numpy(state), torch.from_numpy(action))
    assert q1.shape == q2.shape == (40,)
    np.testing.assert_allclose(q1.numpy(), np.asarray(ref1), **AC_TOL)
    np.testing.assert_allclose(q2.numpy(), np.asarray(ref2), **AC_TOL)
    np.testing.assert_allclose(qmin.numpy(), np.asarray(jnet.q_min(params, js, ja)), **AC_TOL)
    assert not np.allclose(q1.numpy(), q2.numpy())  # two members, two sets of weights


def test_continuous_inits_and_loaders_follow_the_reference():
    gen = torch.Generator().manual_seed(0)
    global_rng = torch.get_rng_state()
    actor = GaussianActorNetwork().init(gen, 3, 1)
    twin = TwinCritic().init(gen, 3, 1)
    assert torch.equal(torch.get_rng_state(), global_rng)  # draws only from `gen`
    # The trunk is an MLP (xavier) with a relu on its last layer; the heads
    # are bare flax Dense layers: lecun-normal, truncated at 2 sigma.
    assert actor.MLP_0.layer_names == ["dense_0", "dense_out"]
    assert actor.MLP_0.last_activation == "relu"
    for head in (actor.mu, actor.log_std):
        std = (1 / 64) ** 0.5 / 0.87962566103423978
        assert head.weight.shape == (1, 64) and (head.bias == 0).all()
        assert head.weight.abs().max() <= 2 * std
    # Twin: flax's stacked layout, (2, in, out); xavier per member, zero bias.
    shapes = {n: tuple(p.shape) for n, p in twin.named_parameters()}
    assert shapes == {
        "MLP_0.dense_0.kernel": (2, 4, 64), "MLP_0.dense_0.bias": (2, 64),
        "MLP_0.dense_1.kernel": (2, 64, 64), "MLP_0.dense_1.bias": (2, 64),
        "MLP_0.dense_out.kernel": (2, 64, 1), "MLP_0.dense_out.bias": (2, 1),
    }
    k = twin.MLP_0.dense_1.kernel
    assert k.abs().max() <= (6 / 128) ** 0.5 and not torch.equal(k[0], k[1])
    assert all((layer.bias == 0).all() for layer in twin.MLP_0.layers())
    params = _np_tree(JaxTwin().init(jax.random.PRNGKey(0), 3, 1))
    with pytest.raises(ValueError):  # not a twin tree
        load_flax_twin_critic_params(twin, {"params": params})
    with pytest.raises(ValueError):  # the members' leading 2 dropped
        load_flax_twin_critic_params(
            twin, jax.tree.map(lambda x: x[0], params)
        )
    with pytest.raises(ValueError):  # a Gaussian actor's tree needs its heads
        load_flax_gaussian_actor_params(actor, {"MLP_0": {}})


def test_mlp_last_activation():
    mlp = MLP(3, (8,), 4, generator=torch.Generator().manual_seed(0), last_activation="tanh")
    plain = MLP(3, (8,), 4, generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1)) * 10
    torch.testing.assert_close(mlp(x), torch.tanh(plain(x)), rtol=0, atol=0)


# The MLP's options. flax's and the port's products sum in other orders:
# rtol 1e-5, atol 1e-6 for values and gradients near zero.
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
MLP_OPTIONS = {
    "layer_norm": dict(use_layer_norm=True),
    "skips": dict(use_skip_connections=True),
    "layer_norm_and_skips": dict(use_layer_norm=True, use_skip_connections=True),
    "tanh": dict(activation="tanh"),
    "lecun": dict(use_xavier_init=False),
}


def _perturbed(params, seed):
    """flax params with every layer norm's scale and bias moved off 1 and 0,
    so that carrying them is tested."""
    rng = np.random.default_rng(seed)
    out = _np_tree(params)
    for name, leaves in out.items():
        if name.startswith("ln_"):
            leaves["scale"] = (1.0 + 0.3 * rng.standard_normal(leaves["scale"].shape)).astype(
                np.float32)
            leaves["bias"] = (0.2 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return out


def _mlp_pair(options, hidden=(8, 8, 16), in_dim=8, out_dim=3, seed=0):
    jmlp = JaxMLP(hidden_dims=hidden, output_dim=out_dim, **options)
    params = _perturbed(jmlp.init(jax.random.PRNGKey(seed), jnp.zeros((1, in_dim)))["params"],
                        seed)
    mlp = MLP(in_dim, hidden, out_dim, generator=torch.Generator().manual_seed(seed), **options)
    load_flax_mlp(mlp, params)
    return jmlp, params, mlp


def _assert_close_to_jax(ours, ref, exact):
    """`ours` within OPT_TOL of JAX's `ref`, plus twice JAX's own distance
    from the float64 value `exact`: through layer norm, float32 rounding of
    either package reaches 1e-5 of a gradient (as for the transformer's,
    tests/test_torch_history.py). JAX's own error is held first, so that a
    wrong formula cannot widen the bound."""
    ours, ref, exact = (np.asarray(a, np.float64) for a in (ours, ref, exact))
    ref_err = np.abs(ref - exact)
    assert ref_err.max() <= OPT_TOL["rtol"] * max(1.0, np.abs(exact).max()), ref_err.max()
    bound = OPT_TOL["atol"] + OPT_TOL["rtol"] * np.abs(ref) + 2 * ref_err
    worst = np.max(np.abs(ours - ref) - bound)
    assert worst <= 0, f"beyond the bound by {worst}"


@pytest.mark.parametrize("name", sorted(MLP_OPTIONS))
def test_mlp_options_match_jax_forward_and_grads(name):
    """Widths 8 -> 8 -> 8 -> 16: skips apply at layers 0 and 1 (layer 0's
    input width equals the first hidden width), not at layer 2."""
    jmlp, params, mlp = _mlp_pair(MLP_OPTIONS[name])
    x = np.random.default_rng(1).standard_normal((17, 8)).astype(np.float32)

    def jax_loss(p, x):
        y = jmlp.apply({"params": p}, x)
        return jnp.sum(jnp.sin(y)), y

    (_, ref), (jgrads, jgx) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    def port(module, dtype):
        xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
        y = module(xt)
        torch.sin(y).sum().backward()
        return y.detach(), xt.grad, dict(module.named_parameters())

    y, gx, named = port(mlp, torch.float32)
    y64, gx64, named64 = port(copy.deepcopy(mlp).double(), torch.float64)
    _assert_close_to_jax(y, ref, y64)
    _assert_close_to_jax(gx, jgx, gx64)
    names = set()
    for layer, leaves in jgrads.items():
        for leaf, g in leaves.items():
            name = f"{layer}.{ {'kernel': 'weight'}.get(leaf, leaf) }"
            names.add(name)
            flip = (lambda a: a.T) if leaf == "kernel" else (lambda a: a)
            _assert_close_to_jax(flip(named[name].grad.numpy()), g,
                                 flip(named64[name].grad.numpy()))
    assert set(named) == names


def test_mlp_lecun_init_is_a_truncated_normal():
    mlp = MLP(256, (256,), 256, generator=torch.Generator().manual_seed(0),
              use_xavier_init=False)
    for layer in mlp.layers():
        w = layer.weight.detach()
        std = np.sqrt(1.0 / w.shape[1])
        assert w.abs().max() <= 2 * std / 0.87962566103423978
        assert abs(w.std().item() - std) < 0.05 * std
        assert (layer.bias == 0).all()


def test_mlp_options_draw_what_the_plain_mlp_draws():
    """Layer norm (scale 1, bias 0) and dropout draw nothing at init: every
    dense layer is the plain MLP's, which is `dense` called in layer order."""
    plain = MLP(5, (8, 8), 3, generator=torch.Generator().manual_seed(0))
    options = MLP(5, (8, 8), 3, generator=torch.Generator().manual_seed(0), use_layer_norm=True,
                  use_skip_connections=True, dropout_rate=0.5, activation="tanh")
    g = torch.Generator().manual_seed(0)
    by_hand = [dense(5, 8, g), dense(8, 8, g), dense(8, 3, g)]
    for a, b, c in zip(plain.layers(), options.layers(), by_hand):
        for t in ("weight", "bias"):
            assert torch.equal(getattr(a, t), getattr(b, t))
            assert torch.equal(getattr(a, t), getattr(c, t))
    assert options.norm_names == ["ln_0", "ln_1"] and plain.norm_names == []
    assert (options.ln_0.scale == 1).all() and (options.ln_0.bias == 0).all()


def test_mlp_dropout_is_off_unless_asked_and_drops_its_rate():
    _, params, mlp = _mlp_pair({"dropout_rate": 0.3})
    jmlp = JaxMLP(hidden_dims=(8, 8, 16), output_dim=3, dropout_rate=0.3)
    x = np.random.default_rng(2).standard_normal((9, 8)).astype(np.float32)
    ref = np.asarray(jmlp.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    plain = MLP(8, (8, 8, 16), 3)
    load_flax_mlp(plain, params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        off = mlp(xt)  # deterministic by default, as flax
        np.testing.assert_allclose(off.numpy(), ref, **OPT_TOL)
        assert torch.equal(off, plain(xt))
        on = mlp(xt, deterministic=False, generator=torch.Generator().manual_seed(3))
        again = mlp(xt, deterministic=False, generator=torch.Generator().manual_seed(3))
        assert torch.equal(on, again) and not torch.equal(on, off)
        with pytest.raises(ValueError, match="generator"):
            mlp(xt, deterministic=False)
    n, rate = 200_000, 0.3
    kept = dropout(torch.ones(n), rate, torch.Generator().manual_seed(4))
    dropped = (kept == 0).float().mean().item()
    assert abs(dropped - rate) < 3 * np.sqrt(rate * (1 - rate) / n)
    torch.testing.assert_close(kept[kept != 0], torch.full_like(kept[kept != 0], 1 / 0.7))
    assert (dropout(torch.ones(8), 1.0, None) == 0).all()  # flax's rate 1


def test_residual_wrapper_and_over_actions_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 4)).astype(np.float32)
    jres = JaxResidualWrapper(inner=flax_nn.Dense(4))
    params = _np_tree(jres.init(jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"])
    ref = np.asarray(jres.apply({"params": jax.tree.map(jnp.asarray, params)}, jnp.asarray(x)))
    inner = dense(4, 4)
    load_flax_dense(inner, params["inner"], "inner")
    with torch.no_grad():
        ours = ResidualWrapper(inner)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, **OPT_TOL)

    state = rng.standard_normal((5, 3)).astype(np.float32)
    actions = rng.standard_normal((5, 7, 2)).astype(np.float32)
    jmlp, mparams, mlp = _mlp_pair({}, hidden=(8,), in_dim=5, out_dim=2)
    japply = lambda s, a: jmlp.apply(  # noqa: E731
        {"params": jax.tree.map(jnp.asarray, mparams)}, jnp.concatenate([s, a], -1))
    ref = np.asarray(jax_over_actions(japply, jnp.asarray(state), jnp.asarray(actions)))
    with torch.no_grad():
        out = over_actions(lambda s, a, k: {"q": mlp(torch.cat([s, a], -1)) * k},
                           torch.from_numpy(state), torch.from_numpy(actions), 1.0)
    assert out["q"].shape == ref.shape == (5, 7, 2)
    np.testing.assert_allclose(out["q"].numpy(), ref, **OPT_TOL)


@pytest.mark.parametrize("jax_net,net", [(JaxVanilla, VanillaQValueNetwork),
                                         (JaxQuantile, QuantileQValueNetwork)])
def test_q_networks_with_layer_norm_match_jax(jax_net, net):
    state, actions = _inputs(B=21)
    jnet = jax_net(use_layer_norm=True)
    params = jnet.init(jax.random.PRNGKey(4), 4, 3, 3)
    params = {"MLP_0": _perturbed(params["MLP_0"], 4)}
    tnet = net(use_layer_norm=True)
    module = tnet.init(torch.Generator().manual_seed(0), 4, 3, 3)
    assert module.MLP_0.norm_names == ["ln_0", "ln_1"]
    load_flax_q_params(module, params)
    jparams = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        q = tnet.q_all(module, torch.from_numpy(state), torch.from_numpy(actions)).numpy()
    ref = np.asarray(jnet.q_all(jparams, jnp.asarray(state), jnp.asarray(actions)))
    np.testing.assert_allclose(q, ref, **OPT_TOL)
    if net is QuantileQValueNetwork:
        with torch.no_grad():
            quantiles = tnet.quantiles_all(module, torch.from_numpy(state),
                                           torch.from_numpy(actions)).numpy()
        ref = np.asarray(jnet.quantiles_all(jparams, jnp.asarray(state), jnp.asarray(actions)))
        np.testing.assert_allclose(quantiles, ref, **OPT_TOL)
    with pytest.raises(ValueError):  # a tree without the layer norms
        load_flax_q_params(module, {"MLP_0": {k: v for k, v in params["MLP_0"].items()
                                              if not k.startswith("ln_")}})


@pytest.mark.parametrize("options", [dict(use_layer_norm=True), dict(use_skip_connections=True),
                                     dict(dropout_rate=0.1), dict(activation="tanh"),
                                     dict(last_activation="relu")])
def test_an_mlp_with_options_never_reaches_fused_mlp(options):
    mlp = MLP(4, (8, 8), 2, **options)
    with pytest.raises(ValueError, match="plain relu chain"):
        mlp.wb()
    with pytest.raises(ValueError, match="plain relu chain"):
        fused_mlp_from_module(mlp, torch.zeros(3, 4))
    assert len(MLP(4, (8, 8), 2, use_xavier_init=False).wb()) == 6  # init only
