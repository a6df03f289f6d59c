"""The runtime's steps: the staged train step (``train``, data-
parallel on a device mesh), pipeline parallelism as F / L / B tasks
(``pipeline``) and the serving steps and plumbing (``serve``: greedy
prefill / decode and the serve step, on a ``model`` axis too, cache priming
and paged-cache row movement)."""
from .pipeline import pipeline_value_and_grad, split_stages
from .train import TrainStepArtifacts, build_train_step, init_train_state

__all__ = [
    "TrainStepArtifacts",
    "build_train_step",
    "init_train_state",
    "pipeline_value_and_grad",
    "split_stages",
]
