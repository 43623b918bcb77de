from repro_torch.data.pipeline import DataConfig, SyntheticCorpus, make_batches

__all__ = ["DataConfig", "SyntheticCorpus", "make_batches"]
