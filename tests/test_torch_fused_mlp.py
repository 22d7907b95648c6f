"""Kernel B1 of the PyTorch port (pearl_tpu_torch/ops/fused_mlp.py) against
the JAX package's fused MLP (pearl_tpu/ops/fused_mlp.py): the plain chain
against `_reference_forward` and the Pallas kernel in interpret mode, and
the autograd.Function's gradients against `jax.grad` through the custom VJP.
The same numpy-made inputs go to both packages. Flax kernels are (in, out);
the port's W is nn.Linear's (out, in), so each W is transposed on the way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pearl_tpu.ops.fused_mlp import _pallas_forward, _reference_forward
from pearl_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
import chip_smoke
from pearl_tpu_torch.neural_networks.common import MLP
from pearl_tpu_torch.ops.fused_mlp import (
    BODIES,
    H100_SMS,
    MAX_LAYERS,
    MAX_WIDTH,
    ROWS_PER_SM,
    TILE_MAX_WIDTH,
    fused_mlp,
    fused_mlp_from_module,
    fused_mlp_reference,
    pick_body,
)

torch.set_num_threads(1)

# Forward: float32 on both sides, sums taken in another order -> 1e-5.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
# Gradients of sum(y^2): the forward's rounding difference is scaled by the
# backward chain; the JAX package holds its own custom VJP to the same 1e-4.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

SHAPES = [(37, (4, 64, 64, 2)), (1031, (5, 32, 48, 16, 3))]


def _operands(B, dims, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, dims[0])).astype(np.float32)
    kernels, biases = [], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        kernels.append((rng.standard_normal((d_in, d_out)) * 0.3).astype(np.float32))
        biases.append((rng.standard_normal((d_out,)) * 0.1).astype(np.float32))
    jax_wb = [jnp.asarray(a) for pair in zip(kernels, biases) for a in pair]
    torch_wb = [
        torch.from_numpy(a) for k, b in zip(kernels, biases) for a in (k.T.copy(), b)
    ]
    return x, jax_wb, torch_wb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("B,dims", SHAPES)
def test_plain_chain_matches_jax_reference_and_pallas(B, dims):
    x, jax_wb, torch_wb = _operands(B, dims, seed=B)
    ours = fused_mlp_reference(torch.from_numpy(x), torch_wb).numpy()
    ref = np.asarray(_reference_forward(jnp.asarray(x), jax_wb))
    pallas = np.asarray(_pallas_forward(jnp.asarray(x), tuple(jax_wb)))  # interpret mode
    assert ours.shape == (B, dims[-1])
    np.testing.assert_allclose(ours, ref, **FWD_TOL)
    np.testing.assert_allclose(ours, pallas, **FWD_TOL)
    wrapped = fused_mlp(torch.from_numpy(x), *torch_wb).numpy()
    np.testing.assert_array_equal(wrapped, ours)  # CPU tensor -> the plain chain


@pytest.mark.parametrize("B,dims", SHAPES)
def test_grads_match_jax_custom_vjp(B, dims):
    x, jax_wb, torch_wb = _operands(B, dims, seed=100 + B)

    def jax_loss(x_, *wb_):
        return jnp.sum(jax_fused_mlp(x_, *wb_) ** 2)

    jax_grads = jax.grad(jax_loss, argnums=tuple(range(1 + len(jax_wb))))(
        jnp.asarray(x), *jax_wb
    )
    leaves = [torch.from_numpy(x).requires_grad_()] + [t.requires_grad_() for t in torch_wb]
    (fused_mlp(*leaves) ** 2).sum().backward()
    for i, (ours, ref) in enumerate(zip(leaves, jax_grads)):
        g = ours.grad.numpy()
        ref = np.asarray(ref)
        if i > 0 and i % 2 == 1:  # a W: (out, in) here, (in, out) in flax
            ref = ref.T
        np.testing.assert_allclose(g, ref, **GRAD_TOL)


def test_cpu_tensor_never_counts_a_launch():
    x, _, torch_wb = _operands(37, (4, 64, 64, 2), seed=7)
    before = fused_mlp.launches
    fused_mlp(torch.from_numpy(x), *torch_wb)
    mlp = MLP(4, (64, 64), 2, generator=torch.Generator().manual_seed(0))
    fused_mlp_from_module(mlp, torch.from_numpy(x)).sum().backward()
    assert fused_mlp.launches == before


def test_module_helpers_give_the_mlp_chain():
    mlp = MLP(5, (8, 8), 3, generator=torch.Generator().manual_seed(1))
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(2))
    wb = mlp.wb()
    assert [tuple(t.shape) for t in wb] == [(8, 5), (8,), (8, 8), (8,), (3, 8), (3,)]
    torch.testing.assert_close(fused_mlp_from_module(mlp, x), mlp(x), rtol=0, atol=0)


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda x, wb: (x.double(), [w.double() for w in wb]), TypeError),
        (lambda x, wb: (x.t().contiguous().t(), wb), ValueError),  # non-contiguous x
        (lambda x, wb: (x, wb[:-1]), ValueError),  # odd operand count
        (lambda x, wb: (x[:, :3].contiguous(), wb), ValueError),  # width mismatch
        (lambda x, wb: (x[0], wb), ValueError),  # x not 2-D
    ],
)
def test_wrapper_rejects_bad_operands(mutate, error):
    x, _, torch_wb = _operands(8, (4, 16, 2), seed=3)
    bad_x, bad_wb = mutate(torch.from_numpy(x), torch_wb)
    with pytest.raises(error):
        fused_mlp(bad_x, *bad_wb)


def test_pick_body_takes_the_main_path_shapes_to_the_new_bodies():
    # The DQN runner's act launch (131072 envs) and its learn launch (batch
    # 1024) on an H100: the tiled and the rows body, never the first design.
    assert pick_body(*chip_smoke.ACT_SHAPE) == "tiled"
    assert pick_body(*chip_smoke.LEARN_SHAPE) == "rows"
    assert chip_smoke.ACT_SHAPE[0] == 131_072 and chip_smoke.LEARN_SHAPE[0] == 1_024


@pytest.mark.parametrize("B,dims", chip_smoke.CHECK_SHAPES)
def test_pick_body_gives_every_checked_shape_a_body_that_takes_it(B, dims):
    body = pick_body(B, dims)
    assert body in BODIES
    if body == "rows":
        assert B <= ROWS_PER_SM * H100_SMS
    else:
        assert B > ROWS_PER_SM * H100_SMS
        assert (body == "tiled") == (max(dims[1:]) <= TILE_MAX_WIDTH)


def test_checked_shapes_reach_every_body():
    assert {pick_body(B, dims) for B, dims in chip_smoke.CHECK_SHAPES} == set(BODIES)


@pytest.mark.parametrize("sms", [1, 108, 132])
def test_pick_body_switches_from_rows_at_32_rows_an_sm(sms):
    dims = (4, 64, 64, 2)
    assert pick_body(ROWS_PER_SM * sms, dims, sms) == "rows"
    assert pick_body(ROWS_PER_SM * sms + 1, dims, sms) == "tiled"
    assert pick_body(ROWS_PER_SM * sms + 1, chip_smoke.WIDE_DIMS, sms) == "general"
    assert pick_body(1, chip_smoke.WIDE_DIMS, sms) == "rows"


def test_pick_body_follows_the_shared_memory_it_is_given():
    dims = (256, 64, 64, 64, 2)  # a 256-wide input: 256 rows of it are 256 KB
    assert pick_body(100_000, dims) == "general"
    assert pick_body(100_000, dims, smem_optin=2**20) == "tiled"
    # The act chain's tile: 64 KB of activations and 19 KB of weights.
    assert pick_body(100_000, (4, 64, 64, 2), smem_optin=84_496) == "tiled"
    assert pick_body(100_000, (4, 64, 64, 2), smem_optin=84_495) == "general"


@pytest.mark.parametrize(
    "B,dims",
    [
        (1024, (4,) + (8,) * (MAX_LAYERS + 1)),  # too many layers
        (1024, (4, MAX_WIDTH + 1, 2)),  # too wide
        (1024, (4, 0, 2)),
        (1024, (4,)),  # no layer
        (100_000, (MAX_WIDTH,) * (MAX_LAYERS + 1)),  # fits no block's shared memory
    ],
)
def test_pick_body_raises_at_the_kernel_limits(B, dims):
    with pytest.raises(ValueError, match="fused_mlp kernel"):
        pick_body(B, dims)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dims", chip_smoke.CHECK_SHAPES)
def test_kernel_matches_plain_chain_on_card(cuda_device, B, dims):
    x, _, torch_wb = _operands(B, dims, seed=B)
    x = torch.from_numpy(x).to(cuda_device)
    wb = [t.to(cuda_device) for t in torch_wb]
    before, by_body = fused_mlp.launches, dict(fused_mlp.launches_by_body)
    out = fused_mlp(x, *wb)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert sum(fused_mlp.launches_by_body.values()) == sum(by_body.values()) + 1
    torch.testing.assert_close(out, fused_mlp_reference(x, wb), **FWD_TOL)
