from leann_tpu_torch.agent.react import ReActAgent, parse_action, Action

__all__ = ["ReActAgent", "parse_action", "Action"]
