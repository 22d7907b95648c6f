"""The ring-conv act path of the PyTorch port against the JAX package on the
CPU: `ops/ring_conv.py`'s plain version (what the wrapper runs on a CPU
tensor) against the Pallas kernel of `pearl_tpu/ops/ring_conv.py` in
interpret mode, and the network's `ring_conv=True` branch against its fence
branch and against the JAX `_q_all_ring`. The CUDA kernel itself runs only on
a card, where `chip_smoke.py` holds it against the same plain version.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pearl_tpu.ops.ring_conv as jrc
import pearl_tpu_torch.neural_networks.q_value_networks as qvn
from pearl_tpu.history_summarization_modules.frame_ring import FrameRingView as JaxView
from pearl_tpu.neural_networks.q_value_networks import CNNQValueNetwork as JaxCNN
from pearl_tpu_torch.history_summarization_modules import FrameRingView
from pearl_tpu_torch.neural_networks import CNNQValueNetwork
from pearl_tpu_torch.ops import ring_conv as trc
from pearl_tpu_torch.utils.jax_params import load_flax_cnn_q_params

torch.set_num_threads(1)

A = 5


def _run_interpreted(*args, **kw):
    """The Pallas kernel on the CPU, as tests/test_ring_conv.py runs it."""
    orig = jrc.pl.pallas_call
    jrc.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        jrc.ring_conv1.clear_cache()
        return jrc.ring_conv1(*args, **kw)
    finally:
        jrc.pl.pallas_call = orig
        jrc.ring_conv1.clear_cache()


def _operands(B, T, H, W, k, OC, seed):
    rng = np.random.default_rng(seed)
    ring = rng.normal(0, 1, (B, T, H * W)).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    valid[0] = False  # an env with no valid frame
    valid[1] = True
    wmat = (rng.normal(0, 1, (T * k * k, OC)) * 0.1).astype(np.float32)
    bias = (rng.normal(0, 1, (OC,)) * 0.1).astype(np.float32)
    return ring, valid, wmat, bias


# The two geometries of tests/test_ring_conv.py, at the smallest batch the
# Pallas kernel's blocks take (one block, and two for the slot rotation).
GEOMETRIES = [(32, 4, 20, 20, 8, 4, 16), (64, 3, 28, 28, 8, 4, 8)]


@pytest.mark.parametrize("B,T,H,W,k,s,OC", GEOMETRIES)
def test_plain_version_matches_the_interpreted_pallas_kernel(B, T, H, W, k, s, OC):
    ring, valid, wmat, bias = _operands(B, T, H, W, k, OC, seed=B)
    want = _run_interpreted(
        jnp.asarray(ring), jnp.asarray(valid), jnp.asarray(wmat), jnp.asarray(bias),
        H=H, W=W, k=k, s=s, batch_block=32,
    )  # (B, OH, OW, OC)
    tensors = [torch.from_numpy(x) for x in (ring, valid, wmat, bias)]
    got = trc.ring_conv1(*tensors, H=H, W=W, k=k, s=s)  # the plain version, on the CPU
    OH, OW = (H - k) // s + 1, (W - k) // s + 1
    assert got.shape == (B, OC, OH, OW) and got.dtype == torch.float32 and got.is_contiguous()
    assert trc.ring_conv1.launches == 0
    assert torch.equal(got, trc.ring_conv1_reference(*tensors, H=H, W=W, k=k, s=s))
    # float32 both ways, the 256-term sum in another order.
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert (got[0] == torch.relu(torch.from_numpy(bias))[:, None, None]).all()  # nothing valid
    assert 0.2 < (got > 0).float().mean().item() < 0.8


def test_plain_version_matches_the_interpreted_pallas_kernel_in_bfloat16():
    B, T, H, W, k, s, OC = GEOMETRIES[0]
    ring, valid, wmat, bias = _operands(B, T, H, W, k, OC, seed=1)
    want = _run_interpreted(
        jnp.asarray(ring).astype(jnp.bfloat16), jnp.asarray(valid), jnp.asarray(wmat),
        jnp.asarray(bias), H=H, W=W, k=k, s=s, batch_block=32,
    )
    assert want.dtype == jnp.bfloat16
    got = trc.ring_conv1(
        torch.from_numpy(ring).to(torch.bfloat16), torch.from_numpy(valid),
        torch.from_numpy(wmat), torch.from_numpy(bias), H=H, W=W, k=k, s=s,
    )
    assert got.dtype == torch.bfloat16
    # The same bfloat16 values multiplied exactly and summed in float32 in
    # another order, then one rounding: one bfloat16 ulp where it falls the
    # other way.
    np.testing.assert_allclose(
        got.float().permute(0, 2, 3, 1).numpy(), np.asarray(want.astype(jnp.float32)),
        rtol=2**-7, atol=2e-5,
    )


def _nets(input_shape, seed=0, **kw):
    jnet = JaxCNN(input_shape=input_shape, hidden_dims=(24,), time_major_stack=True, **kw)
    tnet = CNNQValueNetwork(
        input_shape=input_shape, hidden_dims=(24,), time_major_stack=True, ring_conv=True, **kw)
    params = jnet.init(jax.random.PRNGKey(seed), 0, 0, A)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: x if x.ndim > 1 else jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32)),
        params,
    )
    module = tnet.init(torch.Generator().manual_seed(seed), 0, 0, A)
    load_flax_cnn_q_params(module, jax.tree.map(np.asarray, params))
    return jnet, params, tnet, module


@pytest.mark.parametrize(
    "input_shape,kw",
    [
        ((20, 20, 4), {}),
        ((28, 24, 3), {}),  # not square
        ((12, 12, 4), dict(kernel_sizes=(4, 2), strides=(2, 1))),
        ((12, 12, 2), dict(kernel_sizes=(4, 2), strides=(4, 1), out_channels=(8, 32))),  # k == s
    ],
)
def test_ring_conv_branch_matches_the_fence_branch_and_jax_at_every_cursor(
    input_shape, kw, monkeypatch
):
    H, W, T = input_shape
    jnet, params, tnet, module = _nets(input_shape, **kw)
    fence_net = dataclasses.replace(tnet, ring_conv=False)
    calls = []
    real = trc.ring_conv1
    monkeypatch.setattr(qvn, "ring_conv1", lambda *a, **k: calls.append(1) or real(*a, **k))
    B = 6
    rng = np.random.default_rng(2)
    ring = rng.uniform(0, 255, (B, T, H * W)).astype(np.float32)
    valid = rng.random((B, T)) < 0.7
    for cursor in range(T):
        jview = JaxView(ring=jnp.asarray(ring), valid=jnp.asarray(valid),
                        cursor=jnp.asarray(cursor, jnp.int32))
        # On the CPU the JAX network takes its XLA branch: the same function.
        want = np.asarray(jnet.q_all(params, jview, jnp.zeros((B, A, A))))
        tview = FrameRingView(torch.from_numpy(ring), torch.from_numpy(valid), cursor)
        with torch.no_grad():
            got = tnet.q_all(module, tview, None)
            assert len(calls) == cursor + 1
            fenced = fence_net.q_all(module, tview, None)
            assert len(calls) == cursor + 1
            # A replay-sampled window keeps the fences.
            replayed = tnet.q_all(module, dataclasses.replace(tview, from_replay=True), None)
            assert len(calls) == cursor + 1
        assert torch.equal(fenced, replayed)
        # float32; /255 folded into the weights instead of the input, and the
        # conv taps summed in another order.
        np.testing.assert_allclose(got.numpy(), fenced.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ring_conv_branch_in_bfloat16_and_after_the_cache():
    # The act path under act_dtype="bfloat16": both branches round every
    # layer's output to bfloat16 at their own places: 3e-2 for |Q| under 1.
    jnet, params, tnet, module = _nets((20, 20, 4))
    rng = np.random.default_rng(3)
    ring = torch.from_numpy(rng.uniform(0, 255, (6, 4, 400)).astype(np.float32))
    valid = torch.from_numpy(rng.random((6, 4)) < 0.8)
    half = module.to(torch.bfloat16)
    view = FrameRingView(ring.to(torch.bfloat16), valid, 3)
    with torch.no_grad():
        got = tnet.q_all(half, view, None)
        fenced = dataclasses.replace(tnet, ring_conv=False).q_all(half, view, None)
    assert got.dtype == torch.bfloat16 and fenced.float().abs().max() < 1.0
    np.testing.assert_allclose(got.float().numpy(), fenced.float().numpy(), rtol=0, atol=3e-2)

    # With both options the cache comes first, as in the reference.
    both = dataclasses.replace(tnet, conv1_cache=True)
    module = module.to(torch.float32)
    view = FrameRingView(ring, valid, 1)
    view.cache = both.refresh_cache(module, view)
    with torch.no_grad():
        cached = both.q_all(module, view, None)
        only_cache = dataclasses.replace(both, ring_conv=False).q_all(module, view, None)
    assert torch.equal(cached, only_cache)


def test_applicability_rules_and_errors():
    ok = trc.ring_conv_applicable
    assert ok(4, 84, 84, 1, 8, 4, 0, 16, 2) and ok(4, 84, 84, 1, 8, 4, 0, 16, 4)
    assert ok(3, 21, 19, 1, 5, 3, 0, 4)  # no divisibility needed here
    assert not ok(4, 84, 84, 4, 8, 4, 0, 16)  # multi-channel frames
    assert not ok(4, 84, 84, 1, 8, 4, 1, 16)  # padding
    assert not ok(4, 6, 84, 1, 8, 4, 0, 16)  # kernel larger than the frame
    assert not ok(4, 84, 84, 1, 8, 4, 0, 12)  # a channel count the kernel has no body for
    assert not ok(33, 84, 84, 1, 8, 4, 0, 16)  # more frames than a block's flags
    assert not ok(32, 84, 84, 1, 16, 4, 0, 32)  # the weights alone exceed shared memory

    net = dict(input_shape=(20, 20, 4), time_major_stack=True, ring_conv=True)
    assert CNNQValueNetwork(**net).ring_conv and not CNNQValueNetwork().ring_conv
    with pytest.raises(ValueError, match="time_major_stack=True"):
        CNNQValueNetwork(input_shape=(20, 20, 4), ring_conv=True)
    with pytest.raises(ValueError, match="ring_conv=True does not take"):
        CNNQValueNetwork(**{**net, "input_shape": (20, 20, 8)}, frame_channels=2)
    with pytest.raises(ValueError, match="ring_conv=True does not take"):
        CNNQValueNetwork(**net, paddings=(1, 0))
    with pytest.raises(ValueError, match="ring_conv=True does not take"):
        CNNQValueNetwork(**net, out_channels=(12, 32))


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(ring=torch.zeros((2, 3, 99))), ValueError),  # F != H*W
        (dict(ring=torch.zeros((2, 3, 100), dtype=torch.float16)), TypeError),
        (dict(valid=torch.zeros((2, 3))), TypeError),  # not bool
        (dict(wmat=torch.zeros((3 * 4 * 4 + 1, 8))), ValueError),
        (dict(bias=torch.zeros((7,))), ValueError),
        (dict(wmat=torch.zeros((3 * 4 * 4, 5)), bias=torch.zeros((5,))), ValueError),  # OC
    ],
)
def test_ring_conv1_checks_its_arguments(kwargs, error):
    args = dict(
        ring=torch.zeros((2, 3, 100)), valid=torch.zeros((2, 3), dtype=torch.bool),
        wmat=torch.zeros((3 * 4 * 4, 8)), bias=torch.zeros((8,)),
    )
    args.update(kwargs)
    with pytest.raises(error, match="ring_conv1"):
        trc.ring_conv1(**args, H=10, W=10, k=4, s=2)


BF16, F32 = torch.bfloat16, torch.float32
BENCH = (chip_smoke.VIS_T, chip_smoke.VIS_H, chip_smoke.VIS_W, chip_smoke.VIS_K,
         chip_smoke.VIS_S, chip_smoke.VIS_OC)


def test_pick_body_takes_the_runner_shape_to_the_tensor_core_body():
    # conv1 of the visual workload on its bfloat16 ring: (T, H, W, k, s, OC) =
    # (4, 84, 84, 8, 4, 16); a float32 ring keeps the CUDA-core body (its
    # 2e-5 tolerance rules out TF32), and so does an unaligned ring.
    assert BENCH == (4, 84, 84, 8, 4, 16)
    assert trc.pick_body(BF16, *BENCH) == "mma"
    assert trc.pick_body(F32, *BENCH) == "general"
    assert trc.pick_body(BF16, *BENCH, ring_aligned=False) == "general"
    # Three envs' frames fit beside the weights and two copies of out[b]; with
    # room for one env only the bulk copies could not run ahead.
    assert trc._mma_stages(4, 84, 84, 8, 16, 400, trc._KERNEL_SMEM) == 3
    assert trc.pick_body(BF16, *BENCH, smem=120_000) == "general"
    assert trc.pick_body(BF16, *BENCH, smem=160_000) == "mma"


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", chip_smoke.CONV_SMALL + chip_smoke.CONV_CELLS)
def test_pick_body_gives_every_checked_shape_a_body_that_takes_it(shape, dtype):
    _, T, H, W, k, s, OC = shape
    body = trc.pick_body(dtype, T, H, W, k, s, OC)
    assert body in trc.BODIES
    takes = (dtype == BF16 and k % 8 == 0 and s % 4 == 0 and W % 4 == 0 and OC in (8, 16, 32)
             and (H * W * 2) % 16 == 0)
    assert (body == "mma") == takes
    if body == "mma":  # an A register pair is one aligned 8-byte word
        for pixel in (0, ((H - k) // s + 1) * ((W - k) // s + 1) - 1):
            for lane in range(4):
                _, offset, _ = trc.a_fragment_offsets(
                    pixel, 0, lane, W=W, OW=(W - k) // s + 1, k=k, s=s)
                assert offset % 4 == 0


def test_checked_shapes_reach_both_bodies_in_bfloat16():
    bodies = [trc.pick_body(BF16, *shape[1:]) for shape in chip_smoke.CONV_SMALL]
    assert set(bodies) == set(trc.BODIES)


@pytest.mark.parametrize(
    "args",
    [
        (BF16, 4, 84, 84, 8, 4, 12),  # a channel count no body has
        (BF16, 33, 84, 84, 8, 4, 16),  # more frames than a block's flags
        (BF16, 4, 6, 84, 8, 4, 16),  # kernel larger than the frame
        (torch.float16, 4, 84, 84, 8, 4, 16),
    ],
)
def test_pick_body_raises_for_rings_no_body_takes(args):
    with pytest.raises(ValueError, match="ring_conv1 takes no ring"):
        trc.pick_body(*args)


@pytest.mark.parametrize(
    "T,H,W,k,s",
    [(4, 84, 84, 8, 4), (2, 36, 44, 16, 4), (3, 32, 28, 8, 8)],
)
def test_a_fragment_address_map_is_an_im2col_of_the_staged_frames(T, H, W, k, s):
    """The index algebra of the tensor-core body, in numpy: gathering every
    lane's 8-byte word of every k-step and multiplying it with the rows of
    `wmat` the map names is the convolution, term for term."""
    rng = np.random.default_rng(T * 1000 + k)
    OH, OW, OC = (H - k) // s + 1, (W - k) // s + 1, 8
    frames = rng.integers(0, 255, (T, H * W)).astype(np.float64)  # one env, as staged
    wmat = rng.integers(-8, 8, (T * k * k, OC)).astype(np.float64)
    # Explicit im2col: patch[p, (t*k + ky)*k + kx] = frame t at (oy*s+ky, ox*s+kx).
    img = frames.reshape(T, H, W)
    patches = np.empty((OH * OW, T * k * k))
    for p in range(OH * OW):
        oy, ox = divmod(p, OW)
        patches[p] = img[:, oy * s : oy * s + k, ox * s : ox * s + k].reshape(-1)
    want = patches @ wmat

    ksteps = T * (k // 2) * (k // 8)
    pixels = sorted({0, 1, OW - 1, OW, OH * OW - 1, (OH * OW) // 2})
    for p in pixels:
        got = np.zeros(OC)
        seen = []
        for ks in range(ksteps):
            for c in range(4):  # lane % 4; lane // 4 only picks the pixel
                t, offset, rows = trc.a_fragment_offsets(p, ks, c + 4 * (p % 8), W=W, OW=OW, k=k, s=s)
                assert offset % 4 == 0 and offset + 3 < H * W  # aligned, inside frame t
                word = frames[t, offset : offset + 4]
                np.testing.assert_array_equal(word, patches[p, rows])
                assert rows[0] // (k * k) == t
                got += word @ wmat[rows]
                seen += rows
        assert sorted(seen) == list(range(T * k * k))  # every term once
        np.testing.assert_array_equal(got, want[p])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(37, 3, 28, 28, 8, 4, 8)] + chip_smoke.CONV_SMALL[5:])
def test_kernel_matches_plain_version_on_card(dtype, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU form")
    B, T, H, W, k, s, OC = shape
    B = max(B, 2)  # `_operands` marks env 0 all invalid and env 1 all valid
    ring, valid, wmat, bias = (
        torch.from_numpy(x).cuda() for x in _operands(B, T, H, W, k, OC, seed=9))
    ring = (ring * 50).to(dtype)
    before = (trc.ring_conv1.launches, trc.ring_conv1.mma_launches)
    got = trc.ring_conv1(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)
    torch.cuda.synchronize()
    mma = trc.pick_body(dtype, T, H, W, k, s, OC) == "mma"
    assert (trc.ring_conv1.launches, trc.ring_conv1.mma_launches) == (before[0] + 1, before[1] + mma)
    want = trc.ring_conv1_reference(ring, valid, wmat, bias, H=H, W=W, k=k, s=s)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-7, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
