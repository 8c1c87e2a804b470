"""Synthetic data pipelines (the LM task)."""

from repro_torch.data.synthetic import LMTask, make_lm_task, sample_tokens

__all__ = ["LMTask", "make_lm_task", "sample_tokens"]
