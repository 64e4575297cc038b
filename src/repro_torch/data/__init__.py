from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, PrefetchLoader

__all__ = ["DataConfig", "SyntheticCorpus", "PrefetchLoader"]
