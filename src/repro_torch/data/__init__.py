from repro_torch.data.pipeline import (DataConfig, MemmapCorpus,
                                       SyntheticCorpus, make_corpus)

__all__ = ["DataConfig", "SyntheticCorpus", "MemmapCorpus", "make_corpus"]
