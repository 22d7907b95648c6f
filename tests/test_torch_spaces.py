"""The port's spaces (`pearl_tpu_torch/api/spaces.py`) against the JAX
package's: `clip` and `actions_batch` equal JAX's exactly; the samplers draw
from an explicit generator, and the two packages' random streams never
agree, so their draws are held to their distributions (a chi-square over
20000 index draws, with and without a mask that no draw may break, and a
Kolmogorov-Smirnov test on a bounded and an unbounded box dimension).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from pearl_tpu.api.spaces import BoxSpace as JaxBoxSpace
from pearl_tpu.api.spaces import DiscreteActionSpace as JaxDiscreteActionSpace
from pearl_tpu_torch.api.spaces import BoxSpace, DiscreteActionSpace, DiscreteSpace

torch.set_num_threads(1)

DRAWS = 20_000
P_MIN = 1e-3


def _indices(space, mask=None, seed=0, n=DRAWS):
    g = torch.Generator().manual_seed(seed)
    return np.array([int(space.sample_index(g, mask)) for _ in range(n)])


@pytest.mark.parametrize("masked", [False, True])
def test_sample_index_is_uniform_over_the_available_elements(masked):
    space = DiscreteSpace.range(7)
    mask = torch.tensor([True, False, True, True, False, True, True]) if masked else None
    idx = _indices(space, mask)
    allowed = np.flatnonzero(mask.numpy()) if masked else np.arange(7)
    counts = np.bincount(idx, minlength=7)
    assert counts[np.setdiff1d(np.arange(7), allowed)].sum() == 0  # never a masked index
    assert stats.chisquare(counts[allowed]).pvalue > P_MIN
    again = _indices(space, mask, n=50)
    assert np.array_equal(again, idx[:50])  # the generator alone decides


def test_sample_is_the_element_at_the_sampled_index():
    space = DiscreteActionSpace.create(np.arange(12, dtype=np.float32).reshape(4, 3))
    mask = torch.tensor([False, True, False, True])
    for seed in range(20):
        index = space.sample_index(torch.Generator().manual_seed(seed), mask)
        element = space.sample(torch.Generator().manual_seed(seed), mask)
        assert index.dtype == torch.int64 and index.shape == () and int(index) in (1, 3)
        assert torch.equal(element, space.elements[index])


def test_box_sample_is_uniform_where_bounded_and_normal_where_not():
    space = BoxSpace.create([-2.0, -np.inf, 0.5], [3.0, np.inf, 0.75])
    g = torch.Generator().manual_seed(1)
    draws = torch.stack([space.sample(g, mask=torch.tensor([True])) for _ in range(5_000)])
    assert draws.shape == (5_000, 3) and draws.dtype == torch.float32
    x = draws.numpy()
    assert (x[:, 0] >= -2.0).all() and (x[:, 0] < 3.0).all()
    assert (x[:, 2] >= 0.5).all() and (x[:, 2] < 0.75).all()
    assert stats.kstest(x[:, 0], stats.uniform(loc=-2.0, scale=5.0).cdf).pvalue > P_MIN
    assert stats.kstest(x[:, 2], stats.uniform(loc=0.5, scale=0.25).cdf).pvalue > P_MIN
    assert stats.kstest(x[:, 1], stats.norm.cdf).pvalue > P_MIN
    assert space.sample(torch.Generator().manual_seed(2)).device == space.low.device


def test_clip_and_actions_batch_equal_jax():
    low, high = [-1.0, 0.0, -np.inf], [1.0, 2.0, 5.0]
    x = np.random.default_rng(0).standard_normal((9, 3)).astype(np.float32) * 4
    ours = BoxSpace.create(low, high).clip(torch.from_numpy(x)).numpy()
    ref = np.asarray(JaxBoxSpace.create(low, high).clip(jnp.asarray(x)))
    np.testing.assert_array_equal(ours, ref)
    elements = np.random.default_rng(1).standard_normal((5, 2)).astype(np.float32)
    ours = DiscreteActionSpace.create(elements).actions_batch.numpy()
    ref = np.asarray(JaxDiscreteActionSpace.create(elements).actions_batch)
    np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (5, 2) and ours.dtype == ref.dtype
    ours = DiscreteActionSpace.discrete(4).actions_batch.numpy()
    np.testing.assert_array_equal(ours, np.asarray(JaxDiscreteActionSpace.discrete(4).actions_batch))
