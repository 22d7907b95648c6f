from pearl_tpu_torch.agent.pearl_agent import AgentState, PearlAgent

__all__ = ["AgentState", "PearlAgent"]
