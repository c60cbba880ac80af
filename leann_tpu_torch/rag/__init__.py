from leann_tpu_torch.rag.ask import AskSession, build_prompt

__all__ = ["AskSession", "build_prompt"]
