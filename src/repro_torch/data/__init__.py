from .pipeline import Prefetcher, SyntheticLMDataset, batch_specs

__all__ = ["Prefetcher", "SyntheticLMDataset", "batch_specs"]
