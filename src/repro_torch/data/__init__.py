from repro_torch.data.pipeline import SyntheticLMDataset, Batch, prefetch

__all__ = ["SyntheticLMDataset", "Batch", "prefetch"]
