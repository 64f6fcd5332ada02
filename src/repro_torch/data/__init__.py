from repro_torch.data.pipeline import (
    MarkovChainData, Prefetcher, SyntheticLMData,
)

__all__ = ["SyntheticLMData", "MarkovChainData", "Prefetcher"]
