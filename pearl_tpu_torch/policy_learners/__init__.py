from pearl_tpu_torch.policy_learners.policy_learner import ActionChoice, PolicyLearner

__all__ = ["ActionChoice", "PolicyLearner"]
