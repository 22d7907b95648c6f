"""The plain versions of the port's ring and fence kernels
(pearl_tpu_torch/ops/ring_write.py, layout_fence.py) against the Pallas
functions they replace (pearl_tpu/ops/ring_write.py, layout_fence.py), run in
interpret mode on the CPU as tests/test_layout_fence.py runs them: the same
numpy-made inputs, float32 and bfloat16, results equal exactly. Then the
wrappers' checks: on a CPU tensor they run the plain version and count no
launch, and they reject what the kernels do not take.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pearl_tpu.ops.layout_fence as jlf
import pearl_tpu.ops.ring_write as jrw
from pearl_tpu_torch.ops.layout_fence import (
    copy_fence,
    copy_fence_reference,
    masked_scale_fence,
    masked_scale_fence4,
    masked_scale_fence4_reference,
    masked_scale_fence_reference,
)
from pearl_tpu_torch.ops.ring_write import (
    ring_write,
    ring_write_reference,
    ring_write_where,
    ring_write_where_reference,
)

torch.set_num_threads(1)

DTYPES = [("float32", torch.float32, jnp.float32), ("bfloat16", torch.bfloat16, jnp.bfloat16)]
SHAPES = [(6, 4, 40), (5, 1, 24), (3, 3, 17)]  # (B, T, F)


@contextlib.contextmanager
def interpreted(*jitted):
    """Pallas calls of both reference modules in interpret mode."""
    orig = jlf.pl.pallas_call
    assert jrw.pl is jlf.pl
    jlf.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        for fn in jitted:
            fn.clear_cache()
        yield
    finally:
        jlf.pl.pallas_call = orig
        for fn in jitted:
            fn.clear_cache()


def _to_torch(x, tdtype):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(tdtype)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want.astype(jnp.float32))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def _frames(rng, shape, jdtype):
    # Pixel-like values; rounding to the dtype happens once, here.
    return jnp.asarray(rng.uniform(0.0, 255.0, shape).astype(np.float32)).astype(jdtype)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("B,T,F", SHAPES)
def test_ring_write_matches_pallas(name, tdtype, jdtype, B, T, F):
    rng = np.random.default_rng(0)
    ring, entry = _frames(rng, (B, T, F), jdtype), _frames(rng, (B, F), jdtype)
    for c in range(T):
        with interpreted(jrw.ring_slab_write_tfb):
            want = jrw.ring_write(ring, entry, jnp.int32(c))
        t_ring = _to_torch(ring, tdtype)
        before = t_ring.clone()
        got = ring_write_reference(t_ring, _to_torch(entry, tdtype), c)
        assert got is t_ring  # in place
        _equal(got, want)
        others = [s for s in range(T) if s != c]
        assert torch.equal(got[:, others], before[:, others])


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("B,T,F", SHAPES)
def test_ring_write_where_matches_pallas(name, tdtype, jdtype, B, T, F):
    rng = np.random.default_rng(1)
    ring = _frames(rng, (B, T, F), jdtype)
    obs, reset = _frames(rng, (B, F), jdtype), _frames(rng, (B, F), jdtype)
    done = rng.random(B) < 0.5
    done[0], done[-1] = True, False
    for c in range(T):
        with interpreted(jrw.ring_slab_write_where_tfb):
            want_tfb = jrw.ring_slab_write_where_tfb(
                jnp.transpose(ring, (1, 2, 0)), obs.T, reset.T, jnp.asarray(done), jnp.int32(c)
            )
        want = jnp.transpose(want_tfb, (2, 0, 1))
        t_ring = _to_torch(ring, tdtype)
        got = ring_write_where_reference(
            t_ring, _to_torch(obs, tdtype), _to_torch(reset, tdtype), torch.from_numpy(done), c
        )
        assert got is t_ring
        _equal(got, want)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
def test_copy_fence_matches_pallas(name, tdtype, jdtype):
    rng = np.random.default_rng(2)
    x = _frames(rng, (24, 300), jdtype)
    with interpreted(jlf.copy_fence):
        want = jlf.copy_fence(x)
    _equal(copy_fence_reference(_to_torch(x, tdtype)), want)
    # The newest-frame view of a ring: strided rows in, a contiguous frame out.
    ring = _to_torch(_frames(rng, (6, 4, 30), jdtype), tdtype)
    got = copy_fence_reference(ring[:, 2])
    assert got.is_contiguous() and torch.equal(got, ring[:, 2])
    got += 1  # a copy: the ring is not written through it
    assert not torch.equal(got, ring[:, 2])


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("div", [255.0, 1.0])
def test_masked_scale_fence_matches_pallas(name, tdtype, jdtype, div):
    rng = np.random.default_rng(3)
    B, T, F = 12, 4, 90
    ring = _frames(rng, (B, T, F), jdtype)
    valid = rng.random((B, T)) < 0.6
    with interpreted(jlf.masked_scale_fence):
        want = jlf.masked_scale_fence(ring, jnp.asarray(valid), div=div)
    got = masked_scale_fence_reference(_to_torch(ring, tdtype), torch.from_numpy(valid), div)
    assert got.dtype == tdtype
    _equal(got, want)


@pytest.mark.parametrize("name,tdtype,jdtype", DTYPES)
@pytest.mark.parametrize("div", [255.0, 1.0])
def test_masked_scale_fence4_matches_pallas(name, tdtype, jdtype, div):
    rng = np.random.default_rng(4)
    B, T, H, W = 12, 4, 10, 9
    ring = _frames(rng, (B, T, H * W), jdtype)
    valid = rng.random((B, T)) < 0.6
    with interpreted(jlf.masked_scale_fence4):
        want = jlf.masked_scale_fence4(ring, jnp.asarray(valid), H=H, W=W, div=div)
    got = masked_scale_fence4_reference(
        _to_torch(ring, tdtype), torch.from_numpy(valid), H=H, W=W, div=div
    )
    assert got.shape == (B, T, H, W) and got.dtype == tdtype
    _equal(got, want)


def test_fence_against_the_unfenced_path():
    # The reference's unfenced conv input is `ring * valid / 255` with a true
    # divide in the ring dtype: float32 agrees to rtol 2e-7 (one ulp, as
    # tests/test_layout_fence.py:40-43), bfloat16 to one bfloat16 ulp (2^-8
    # relative).
    rng = np.random.default_rng(5)
    ring = rng.uniform(0.0, 255.0, (8, 4, 64)).astype(np.float32)
    valid = rng.random((8, 4)) < 0.7
    got = masked_scale_fence_reference(torch.from_numpy(ring), torch.from_numpy(valid))
    want = np.asarray(jnp.asarray(ring) * jnp.asarray(valid)[..., None].astype(jnp.float32) / 255.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-7, atol=0)
    jring = jnp.asarray(ring).astype(jnp.bfloat16)
    want = jring * jnp.asarray(valid)[..., None].astype(jnp.bfloat16) / 255.0
    got = masked_scale_fence_reference(_to_torch(jring, torch.bfloat16), torch.from_numpy(valid))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2.0**-8, atol=0
    )


def test_wrappers_run_the_plain_version_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(6)
    ring = torch.from_numpy(rng.uniform(0, 255, (4, 3, 10)).astype(np.float32))
    obs = torch.from_numpy(rng.uniform(0, 255, (4, 10)).astype(np.float32))
    reset = torch.from_numpy(rng.uniform(0, 255, (4, 10)).astype(np.float32))
    done = torch.tensor([True, False, False, True])
    valid = torch.tensor(rng.random((4, 3)) < 0.5)
    wrappers = (ring_write, ring_write_where, copy_fence, masked_scale_fence, masked_scale_fence4)
    before = [w.launches for w in wrappers]

    r = ring.clone()
    assert ring_write(r, obs, 1) is r
    assert torch.equal(r, ring_write_reference(ring.clone(), obs, 1))
    r = ring.clone()
    assert ring_write_where(r, obs, reset, done, 2) is r
    assert torch.equal(r, ring_write_where_reference(ring.clone(), obs, reset, done, 2))
    assert torch.equal(r[0, 2], reset[0]) and torch.equal(r[1, 2], obs[1])
    assert torch.equal(copy_fence(ring[:, 0]), ring[:, 0])
    assert torch.equal(masked_scale_fence(ring, valid), masked_scale_fence_reference(ring, valid))
    assert torch.equal(
        masked_scale_fence4(ring, valid, H=2, W=5),
        masked_scale_fence4_reference(ring, valid, H=2, W=5),
    )
    assert [w.launches for w in wrappers] == before


def test_ring_write_rejects_what_the_kernel_does_not_take():
    ring = torch.zeros((4, 3, 10))
    obs = torch.ones((4, 10))
    done = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="contiguous"):
        ring_write(torch.zeros((4, 10, 3)).transpose(1, 2), obs, 0)
    for cursor in (-1, 3, torch.tensor(1)):
        with pytest.raises(ValueError, match="cursor"):
            ring_write(ring, obs, cursor)
        with pytest.raises(ValueError, match="cursor"):
            ring_write_where(ring, obs, obs, done, cursor)
    with pytest.raises(TypeError, match="bfloat16"):
        ring_write(ring, obs.to(torch.bfloat16), 0)
    with pytest.raises(TypeError, match="float64"):
        ring_write_where(ring, obs, obs.double(), done, 0)
    with pytest.raises(ValueError, match="shape"):
        ring_write(ring, torch.ones((4, 9)), 0)
    with pytest.raises(ValueError, match="inner stride"):
        ring_write(ring, torch.ones((4, 20))[:, ::2], 0)
    with pytest.raises(TypeError, match="bool"):
        ring_write_where(ring, obs, obs, done.float(), 0)
    with pytest.raises(ValueError, match="on meta"):
        ring_write(ring, obs.to("meta"), 0)
    assert torch.equal(ring, torch.zeros((4, 3, 10)))  # nothing was written


def test_fences_reject_what_the_kernels_do_not_take():
    ring = torch.zeros((4, 3, 10))
    valid = torch.ones((4, 3), dtype=torch.bool)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        masked_scale_fence(ring.double(), valid)
    with pytest.raises(TypeError, match="bool"):
        masked_scale_fence(ring, valid.float())
    with pytest.raises(TypeError, match="bool"):
        masked_scale_fence4(ring, valid[:, :2], H=2, W=5)
    with pytest.raises(ValueError, match="contiguous"):
        masked_scale_fence(torch.zeros((4, 10, 3)).transpose(1, 2), valid)
    with pytest.raises(ValueError, match="H\\*W"):
        masked_scale_fence4(ring, valid, H=3, W=3)
    with pytest.raises(ValueError, match=r"\(B, F\)"):
        copy_fence(ring)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        copy_fence(torch.zeros((2, 3), device="meta"))


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        ring = (torch.rand((37, 3, 301), device="cuda", generator=gen) * 255).to(dtype)
        obs = (torch.rand((37, 301), device="cuda", generator=gen) * 255).to(dtype)
        reset = (torch.rand((37, 301), device="cuda", generator=gen) * 255).to(dtype)
        done = torch.rand((37,), device="cuda", generator=gen) < 0.3
        valid = torch.rand((37, 3), device="cuda", generator=gen) < 0.7
        for c in range(3):
            assert torch.equal(
                ring_write(ring.clone(), obs, c), ring_write_reference(ring.clone(), obs, c)
            )
            assert torch.equal(
                ring_write_where(ring.clone(), obs, reset, done, c),
                ring_write_where_reference(ring.clone(), obs, reset, done, c),
            )
            assert torch.equal(copy_fence(ring[:, c]), ring[:, c])
        assert torch.equal(
            masked_scale_fence(ring, valid), masked_scale_fence_reference(ring, valid)
        )
        assert torch.equal(
            masked_scale_fence4(ring, valid, H=7, W=43),
            masked_scale_fence4_reference(ring, valid, H=7, W=43),
        )
