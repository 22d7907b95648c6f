"""The data-parallel driver and runner of the port on two gloo ranks: the
reference's mesh tests (tests/test_online_curves_and_mesh.py:153-349,
tests/test_data_parallel.py, tests/integration/test_multiprocess_dp.py and
the data-parallel half of tests/test_checkpoint_population_dp.py:64-107), at
the reference's sizes or, for the longest runs, at a half or a quarter of
their env steps.

The ranks (`tests/torch_parallel_worker.py`, group "online") are spawned once
for the whole file and run every scenario; each test reads its scenario's
results. Where the reference measures a replica spread over a stacked state,
the ranks here return their replicated leaves, which must be equal bit for
bit. The ranks also record each dispatch's statistics before and after the
fold over the mesh; the folded ones must be what the reference makes of the
same per-rank arrays (`_fold_summary_rows`, and its step-major, rank-blocked
order of full mode's episodes).
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from pearl_tpu.training.online import (
    _S_ENVS_FIN,
    _S_RECENT,
    _S_TOTAL_FIN,
    _fold_summary_rows,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    directory = tmp_path_factory.mktemp("parallel_online")
    context = worker.start("online", directory)
    worker.send("online", directory)
    return worker.finish(context, "online", directory)


def _scenario(ranks, name):
    return [r[name] for r in ranks]


def assert_equal_leaves(a: dict, b: dict):
    assert a.keys() == b.keys() and a
    for name in a:
        assert torch.equal(a[name], b[name]), name


def test_mesh_driver_summary_early_stop_and_replica_sync(ranks):
    r0, r1 = _scenario(ranks, "mesh_summary_early_stop")
    for r in (r0, r1):
        assert r["reached"]
        assert r["total_steps"] < 300_000 and r["total_episodes"] > 0
    # Every rank folds the same global statistics and stops at the same dispatch.
    assert r0["total_steps"] == r1["total_steps"]
    assert np.array_equal(r0["curve"], r1["curve"])
    assert_equal_leaves(r0["learner"], r1["learner"])
    # Replay shards are the ranks' own: the same shape, other contents.
    assert r0["replay"].shape == r1["replay"].shape
    assert not torch.equal(r0["replay"], r1["replay"])


def test_mesh_summary_fold_is_the_references(ranks):
    r0, r1 = _scenario(ranks, "mesh_summary_early_stop")
    assert len(r0["folds"]) == len(r1["folds"]) > 1
    rows = []
    for (own0, folded0), (own1, folded1) in zip(r0["folds"], r1["folds"]):
        expected = _fold_summary_rows(np.stack([own0.numpy(), own1.numpy()]))
        assert np.array_equal(folded0.numpy(), expected)
        assert np.array_equal(folded1.numpy(), expected)
        rows.append(expected)
    rows = np.concatenate(rows)
    # The ranks' rows tell the envs-weighted mean from a plain mean or sum.
    own = np.stack([np.concatenate([o.numpy() for o, _ in r["folds"]]) for r in (r0, r1)])
    assert not np.array_equal(own[..., _S_RECENT].mean(axis=0), rows[:, _S_RECENT])
    assert not np.array_equal(own[..., _S_RECENT].sum(axis=0), rows[:, _S_RECENT])
    assert np.array_equal(r0["curve"], rows[:, _S_RECENT])
    assert r0["total_episodes"] == int(rows[-1, _S_TOTAL_FIN])
    # The reference's stopping rule on those rows (target 12 over a window of
    # 4 finished episodes and 4 of the 8 envs). The fetch reads one dispatch
    # behind, so the run ends one dispatch after the first that hits.
    hit = ((rows[:, _S_TOTAL_FIN] >= 4) & (rows[:, _S_ENVS_FIN] >= 4)
           & (rows[:, _S_RECENT] >= 12.0)).reshape(len(r0["folds"]), -1).any(axis=1)
    assert hit.any() and len(r0["folds"]) == int(np.argmax(hit)) + 2


def _ring_episodes(folds, capacity):
    """The returns in the curves mode's per-rank rings, drained rank by rank
    each dispatch as the reference drains its devices (no wrap: nothing was
    dropped)."""
    drained, out = [0] * len(folds[0][1]), []
    for _, gathered in folds:
        for rank, block in enumerate(gathered.numpy()):
            ring = block[:-2].view(np.float32).reshape(3, capacity)
            count = int(block[-2:].view(np.int64)[0])
            out.extend(ring[0, np.arange(drained[rank], count) % capacity].tolist())
            drained[rank] = count
    return np.asarray(out)


def test_mesh_full_and_curves_fold_gathers_in_rank_order(ranks):
    r0, r1 = _scenario(ranks, "mesh_curves")
    for key in ("folds", "full_folds"):
        assert len(r0[key]) == len(r1[key]) > 0
        for (own0, folded0), (own1, folded1) in zip(r0[key], r1[key]):
            assert torch.equal(folded0, torch.stack([own0, own1]))
            assert torch.equal(folded1, torch.stack([own0, own1]))
    # Full mode: the reference's order, (ranks, 4, steps, B) concatenated
    # along the envs, step-major with the env order rank-blocked in a step.
    step_major, rank_major = [], []
    for (own0, _), (own1, _) in zip(r0["full_folds"], r1["full_folds"]):
        arr = np.concatenate([own0.numpy(), own1.numpy()], axis=-1)
        done = arr[0].reshape(-1) > 0.5
        step_major.extend(arr[1].reshape(-1)[done].tolist())
        for own in (own0.numpy(), own1.numpy()):
            rank_major.extend(own[1].reshape(-1)[own[0].reshape(-1) > 0.5].tolist())
    assert step_major != rank_major  # the data tells the two orders apart
    assert np.array_equal(r0["full_returns"], np.asarray(step_major))
    assert np.array_equal(r1["full_returns"], np.asarray(step_major))
    assert np.array_equal(r0["returns"], _ring_episodes(r0["folds"], 1024))


def test_mesh_num_envs_must_divide(ranks):
    for message in _scenario(ranks, "mesh_num_envs_must_divide"):
        assert message.startswith("ValueError") and "divide" in message


def test_mesh_curves_mode(ranks):
    r0, r1 = _scenario(ranks, "mesh_curves")
    assert r0["dropped"] == 0
    assert len(r0["returns"]) > 0
    assert r0["total_episodes"] == len(r0["returns"])
    assert (r0["returns"] >= 1.0).all()  # CartPole pays 1 a step
    assert np.array_equal(r0["returns"], r1["returns"])
    assert_equal_leaves(r0["learner"], r1["learner"])
    # Full mode at the same seed runs the same episodes: its fold orders them
    # step-major (env order rank-blocked), the curves' rank by rank.
    assert np.array_equal(np.sort(r0["full_returns"]), np.sort(r0["returns"]))
    assert np.array_equal(r0["full_returns"], r1["full_returns"])


def test_mesh_ppo_learn_then_clear(ranks):
    r0, r1 = _scenario(ranks, "mesh_ppo_learn_then_clear")
    for r in (r0, r1):
        assert r["replay_size"] == 0  # cleared after the last learn
        assert r["steps"] == 4
    assert_equal_leaves(r0["learner"], r1["learner"])


def test_mesh_lstm_summarizer_carry(ranks):
    r0, r1 = _scenario(ranks, "mesh_lstm_summarizer_carry")
    # Per-env LSTM windows are the ranks' own: 2 envs each.
    for r in (r0, r1):
        carry = next(iter(r["carry"].values()))
        assert carry.shape[0] == 2 and torch.isfinite(carry).all()
        assert r["summarizer_moves"] > 0
    assert_equal_leaves(r0["learner"], r1["learner"])
    assert any("summarizer_params" in name for name in r0["learner"])


def test_mesh_csac_rc_safety_lambda_sync(ranks):
    r0, r1 = _scenario(ranks, "mesh_csac_rc_lambda_sync")
    assert torch.isfinite(r0["lambda"]) and r0["lambda"].dim() == 0
    assert torch.equal(r0["lambda"], r1["lambda"])  # the averaged cost estimate
    assert torch.equal(r0["log_alpha"], r1["log_alpha"])  # the averaged alpha gradient
    assert_equal_leaves(r0["learner"], r1["learner"])
    assert any(name.startswith("['safety'].critic_params") for name in r0["learner"])


def test_mesh_restore_and_reshard(ranks):
    r0, r1 = _scenario(ranks, "mesh_restore_and_reshard")
    assert_equal_leaves(r0["resumed"], r1["resumed"])  # resumed on the same mesh
    assert r0["resumed_step"] == r1["resumed_step"] > 0
    # 2 -> 1: rank 0 alone in the mesh of one, carrying on from the states.
    assert r0["member"] and not r1["member"]
    assert r0["narrow_steps"] == 512 and "narrow_steps" not in r1
    assert r0["wide"] == (2, True, True)  # 1 -> 2: two independent copies


def test_mesh_wrong_stack_width_raises(ranks):
    for message in _scenario(ranks, "mesh_wrong_stack_width_raises"):
        assert message.startswith("ValueError") and "reshard_agent_state" in message


def test_check_replication_catches_missing_pmean(ranks):
    for message in _scenario(ranks, "check_replication_catches_missing_pmean"):
        assert message.startswith("ValueError") and "missing its pmean" in message
        assert "['learner'].params.MLP_0.dense_0.weight" in message


def test_check_replication_passes_for_synced_learner(ranks):
    r0, r1 = _scenario(ranks, "check_replication_passes_for_synced_learner")
    assert r0["total_steps"] >= 1024
    assert_equal_leaves(r0["learner"], r1["learner"])


def test_dp_runner_replicas_stay_in_sync(ranks):
    r0, r1 = _scenario(ranks, "dp_runner_replicas_stay_in_sync")
    assert_equal_leaves(r0["learner"], r1["learner"])
    assert r0["step"] == r1["step"] == 2  # learning happened
    # The env shards differ (each rank's own generator).
    assert any(not torch.equal(r0["env"][k], r1["env"][k]) for k in r0["env"])
    assert r0["rewards"] == r1["rewards"]  # the mean over ranks
    assert r0["n_devices"] == 2 and r0["env_steps_per_call"] == 4 * 4 * 2


def test_two_process_data_parallel_stays_in_sync(ranks):
    r0, r1 = _scenario(ranks, "two_process_data_parallel")
    assert r0["size"] == r1["size"] == 2
    assert r0["params_hash"] == r1["params_hash"], "learner replicas diverged across processes"
    assert r0["reward"] == r1["reward"], "the summed reward disagrees"


def test_dp_state_checkpoint_roundtrip_and_mesh_width_change(ranks):
    r0, r1 = _scenario(ranks, "dp_checkpoint_and_mesh_width_change")
    assert r0["roundtrip"] == "" == r1["roundtrip"]
    assert r0["step_before"] > 0
    # 2 -> 1 on rank 0: the step counter carries on from the saved state.
    steps, step = r0["narrow"]
    assert steps == 256 and step > r0["step_before"]
    assert "narrow" not in r1
    # 1 -> 2: both ranks run on from the narrow run's state, in sync.
    assert r0["wide"][0] == r1["wide"][0] == 256
    assert_equal_leaves(r0["wide"][1], r1["wide"][1])
